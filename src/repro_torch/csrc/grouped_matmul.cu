// Grouped (per-expert) matrix product for the MoE expert FFN.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul/
// grouped_matmul.py (`grouped_matmul`, body `_gmm_kernel`):
//   y[e] = x[e] @ w[e]   for x [E, C, D], w [E, D, F], f32 accumulation,
//   rows >= counts[e] written as 0 (counts == nullptr: every row is valid).
//
// Bound on the card: the product needs 2*E*C*D*F operations against
// E*D*F weights, i.e. about C operations per weight byte in bf16.  Prefill
// (C of thousands of rows) sits above the H100's ~295 op/byte ridge and is
// bound by the tensor cores (989 TFLOP/s bf16); decode (C = 256) sits below
// it and is bound by reading the weights once (3.35 TB/s).
//
// Three instances, chosen by the wrapper's shape rule (never as a fallback):
//
// tma (bf16, D and F multiples of 8, 16-byte aligned bases): the serving
//   path.  A persistent grid of one block per SM walks the output tiles
//   expert by expert; inside an expert, groups of up to 8 row tiles share
//   each weight tile, the row tiles of one column tile next to each other,
//   so at decode (two row tiles) each weight tile comes from HBM once and
//   from L2 the second time, and at prefill the tiles in flight read 8 row
//   tiles of x and ~17 column tiles of w.  A block is one producer warp and
//   two consumer warpgroups.  The producer (its registers lowered with
//   setmaxnreg) keeps a ring of 5 stages full with TMA loads through 3-D
//   tensor maps ([E, C, D] and [E, D, F], so a K tile never reads the next
//   expert; TMA zero-fills what lies past C, D or F), each stage an x tile
//   [128 x 64] and a w tile [64 x 128] in 128-byte swizzle, with a full and
//   an empty mbarrier per stage.  Each consumer warpgroup runs
//   wgmma.mma_async m64n128k16 (B N-major through the transpose bit) on its
//   64-row half, f32 accumulators in registers, one k-block's products in
//   flight while it releases the previous stage.  The epilogue masks rows
//   >= counts[e] to zero, converts to bf16 and writes 16-byte vectors
//   through a shared tile.  A row tile wholly past counts[e] loads nothing,
//   runs no products and only writes zeros.
//   The backward's products take an operand transposed without a copy
//   (`layout`): x stored as x^T [E, D, C] (dW = x^T dy) is loaded as two
//   64 x 64 boxes per stage like w's and read M-major (wgmma's A transpose
//   bit), and w stored as w^T [E, F, D] (dX = dy w^T) is loaded as one
//   128 x 64 box like x's and read K-major (B's transpose bit clear).  The
//   ring, the tile walk and the epilogue do not change.
// wmma (bf16, any shape): WMMA 16x16x16 bf16 fragments on a 128x128x32
//   block tile shared by 8 warps, synchronous loads, ragged edges masked;
//   it takes the shapes TMA cannot (D or F not a multiple of 8).
// simt (f32): 64x64x16 tiles, 4x4 outputs a thread, plain f32 FMAs, so no
//   TF32 rounding enters; it serves the f32 checks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16, any shape: WMMA on tensor cores (the first kernel) -----------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWarpsN = 4;                 // 2 x 4 warps, each 64 x 32
constexpr int kWM = 64, kWN = 32;
constexpr int kFragM = kWM / 16, kFragN = kWN / 16;
constexpr int kPad = 8;                    // keeps rows 16-byte aligned
constexpr int kThreadsBf16 = 256;

__device__ __forceinline__ void load_tile_row8(
    bf16* s_dst, const bf16* g_row, long long g_col, long long n_cols,
    bool row_ok, bool vec) {
  // Eight consecutive elements of one row; zero where out of range.
  if (row_ok && vec && g_col + 8 <= n_cols) {
    *reinterpret_cast<uint4*>(s_dst) =
        *reinterpret_cast<const uint4*>(g_row + g_col);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s_dst[i] = (row_ok && g_col + i < n_cols) ? g_row[g_col + i]
                                              : __float2bfloat16(0.0f);
  }
}

__global__ void __launch_bounds__(kThreadsBf16)
gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ y, const int* __restrict__ counts, int C,
                int D, int F, bool x_vec, bool w_vec) {
  using namespace nvcuda;
  const int e = blockIdx.z;
  const long long m0 = (long long)blockIdx.y * kBM;
  const long long n0 = (long long)blockIdx.x * kBN;
  int cnt = counts ? counts[e] : C;
  cnt = cnt < 0 ? 0 : (cnt > C ? C : cnt);
  const bf16* xe = x + (long long)e * C * D;
  const bf16* we = w + (long long)e * D * F;
  bf16* ye = y + (long long)e * C * F;

  if (m0 >= cnt) {  // the whole row tile is masked: no K loop, zeros out
    for (int t = threadIdx.x; t < kBM * kBN; t += kThreadsBf16) {
      const long long r = m0 + t / kBN, c = n0 + t % kBN;
      if (r < C && c < F) ye[r * F + c] = __float2bfloat16(0.0f);
    }
    return;
  }

  __shared__ __align__(32) bf16 As[kBM][kBK + kPad];
  __shared__ __align__(32) bf16 Bs[kBK][kBN + kPad];
  __shared__ __align__(32) float Cs[kThreadsBf16 / 32][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (long long k0 = 0; k0 < D; k0 += kBK) {
    for (int c = threadIdx.x; c < kBM * kBK / 8; c += kThreadsBf16) {
      const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const long long gr = m0 + row;
      load_tile_row8(&As[row][col], xe + (gr < C ? gr : 0) * D, k0 + col, D,
                     gr < C, x_vec);
    }
    for (int c = threadIdx.x; c < kBK * kBN / 8; c += kThreadsBf16) {
      const int row = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
      const long long gk = k0 + row;
      load_tile_row8(&Bs[row][col], we + (gk < D ? gk : 0) * F, n0 + col, F,
                     gk < D, w_vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * kWM + i * 16][kk], kBK + kPad);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * kWN + j * 16], kBN + kPad);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: one 16x16 fragment at a time through this warp's scratch,
  // masked to the ragged edge and to the valid rows.
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int t = lane; t < 256; t += 32) {
        const long long r = m0 + wm * kWM + i * 16 + t / 16;
        const long long c = n0 + wn * kWN + j * 16 + t % 16;
        if (r < C && c < F)
          ye[r * F + c] = __float2bfloat16(r < cnt ? cs[t] : 0.0f);
      }
      __syncwarp();
    }
  }
}

// ---- f32: SIMT FMAs, no TF32 ---------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16, kTM = 4, kTN = 4;
constexpr int kThreadsF32 = 256;

__global__ void __launch_bounds__(kThreadsF32)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, const int* __restrict__ counts, int C,
               int D, int F) {
  const int e = blockIdx.z;
  const long long m0 = (long long)blockIdx.y * kFM;
  const long long n0 = (long long)blockIdx.x * kFN;
  int cnt = counts ? counts[e] : C;
  cnt = cnt < 0 ? 0 : (cnt > C ? C : cnt);
  const float* xe = x + (long long)e * C * D;
  const float* we = w + (long long)e * D * F;
  float* ye = y + (long long)e * C * F;

  if (m0 >= cnt) {
    for (int t = threadIdx.x; t < kFM * kFN; t += kThreadsF32) {
      const long long r = m0 + t / kFN, c = n0 + t % kFN;
      if (r < C && c < F) ye[r * F + c] = 0.0f;
    }
    return;
  }

  __shared__ float As[kFK][kFM + 4];   // transposed: As[k][row]
  __shared__ float Bs[kFK][kFN + 4];
  const int ty = threadIdx.x / (kFN / kTN), tx = threadIdx.x % (kFN / kTN);
  float acc[kTM][kTN] = {};

  for (long long k0 = 0; k0 < D; k0 += kFK) {
    for (int c = threadIdx.x; c < kFM * kFK; c += kThreadsF32) {
      const int row = c / kFK, k = c % kFK;
      const long long gr = m0 + row, gk = k0 + k;
      As[k][row] = (gr < C && gk < D) ? xe[gr * D + gk] : 0.0f;
    }
    for (int c = threadIdx.x; c < kFK * kFN; c += kThreadsF32) {
      const int k = c / kFN, col = c % kFN;
      const long long gk = k0 + k, gc = n0 + col;
      Bs[k][col] = (gk < D && gc < F) ? we[gk * F + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[k][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[k][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long r = m0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long c = n0 + tx * kTN + j;
      if (r < C && c < F) ye[r * F + c] = r < cnt ? acc[i][j] : 0.0f;
    }
  }
}


// ---- bf16 on Hopper: TMA ring, wgmma, warp-specialised, persistent -------

namespace tma {

constexpr int kBM = 128, kBN = 128, kBK = 64;  // kBK * 2 bytes: one swizzle row
constexpr int kStages = 5;
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kGroupM = 8;                     // row tiles sharing a w tile
constexpr int kXBytes = kBM * kBK * 2;         // 16 KB, one TMA box
constexpr int kWBox = kBK * 64 * 2;            // 8 KB: a 64 x 64 box of w
constexpr int kWBytes = kBK * kBN * 2;         // two boxes side by side
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kEpiLd = kBN + 8;                // padded bf16 row of the epilogue
constexpr int kEpiBytes = 64 * kEpiLd * 2;
constexpr int kBarOffset = kStages * kStageBytes + kConsumers * kEpiBytes;
constexpr int kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.  A
// wait that lasts ~10 s traps, so that a fault ends the kernel with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 34)) {
      asm volatile("trap;");
    }
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x128] += a[64x16] @ b[16x128]: A K-major (kTransA = 0) or M-major
// (1), B N-major (kTransB = 1) or K-major (0).
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

struct Tile {
  int e, m, n;
};

// The t-th output tile: experts outermost; inside an expert, groups of
// kGroupM row tiles, and inside a group the row tiles of one column tile
// next to each other.
__device__ __forceinline__ Tile tile_of(long long t, int m_tiles,
                                        int n_tiles) {
  const long long per_e = (long long)m_tiles * n_tiles;
  Tile r;
  r.e = (int)(t / per_e);
  const int i = (int)(t % per_e);
  const int per_group = kGroupM * n_tiles;
  const int first_m = (i / per_group) * kGroupM;
  const int group_m = min(m_tiles - first_m, kGroupM);
  const int j = i % per_group;
  r.m = first_m + j % group_m;
  r.n = j / group_m;
  return r;
}

__device__ __forceinline__ int valid_rows(const int* counts, int e, int C) {
  int cnt = counts ? counts[e] : C;
  return cnt < 0 ? 0 : (cnt > C ? C : cnt);
}

// kTransA: x holds x^T [E, D, C]; kTransB: w holds w^T [E, F, D].
template <int kTransA, int kTransB>
__global__ void __launch_bounds__(kThreads, 1)
gmm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               bf16* __restrict__ y, const int* __restrict__ counts, int E,
               int C, int D, int F) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the ring to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;

  const int m_tiles = (C + kBM - 1) / kBM;
  const int n_tiles = (F + kBN - 1) / kBN;
  const int k_blocks = (D + kBK - 1) / kBK;
  const long long n_total = (long long)E * m_tiles * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < n_total; t += gridDim.x) {
        const Tile tl = tile_of(t, m_tiles, n_tiles);
        if (tl.m * kBM >= valid_rows(counts, tl.e, C)) continue;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* xs = smem + stage * kStageBytes;
          unsigned char* ws = xs + kXBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          if (kTransA) {  // two [64 k x 64 m] boxes, m innermost
            tma_load_3d(xs, &xmap, &full[stage], tl.m * kBM, kb * kBK, tl.e);
            tma_load_3d(xs + kWBox, &xmap, &full[stage], tl.m * kBM + 64,
                        kb * kBK, tl.e);
          } else {        // one [128 m x 64 k] box, k innermost
            tma_load_3d(xs, &xmap, &full[stage], kb * kBK, tl.m * kBM, tl.e);
          }
          if (kTransB) {  // one [128 n x 64 k] box, k innermost
            tma_load_3d(ws, &wmap, &full[stage], kb * kBK, tl.n * kBN, tl.e);
          } else {        // two [64 k x 64 n] boxes, n innermost
            tma_load_3d(ws, &wmap, &full[stage], tl.n * kBN, kb * kBK, tl.e);
            tma_load_3d(ws + kWBox, &wmap, &full[stage], tl.n * kBN + 64,
                        kb * kBK, tl.e);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma on 64 rows each, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    bf16* epi = reinterpret_cast<bf16*>(smem + kStages * kStageBytes +
                                        wg * kEpiBytes);
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (long long t = blockIdx.x; t < n_total; t += gridDim.x) {
      const Tile tl = tile_of(t, m_tiles, n_tiles);
      const int cnt = valid_rows(counts, tl.e, C);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      if (tl.m * kBM < cnt) {
        int prev = -1;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&full[stage], phase);
          // this warpgroup's 64 rows: the second half of the k-innermost
          // box, or the second of the two m-innermost boxes
          const uint32_t xa = smem_u32(smem + stage * kStageBytes) +
                              wg * (kTransA ? kWBox : 64 * 128);
          const uint32_t wa = smem_u32(smem + stage * kStageBytes + kXBytes);
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            // K-major (k innermost): 16 k = 32 bytes along the swizzled
            // row; 8-row groups 1024 bytes apart.  MN-major: 16 k = two
            // 8-row groups of 1024 bytes; the next 64 columns one 8 KB box
            // on.
            const uint64_t da = kTransA ? sw128_desc(xa + kk * 2048, kWBox,
                                                     1024)
                                        : sw128_desc(xa + kk * 32, 16, 1024);
            const uint64_t db = kTransB ? sw128_desc(wa + kk * 32, 16, 1024)
                                        : sw128_desc(wa + kk * 2048, kWBox,
                                                     1024);
            wgmma_m64n128k16<kTransA, !kTransB>(acc, da, db);
          }
          wgmma_commit();
          fence_acc(acc);
          wgmma_wait<1>();  // the previous k-block's products are done
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      }

      // Epilogue: rows >= cnt are zero; bf16 pairs into this warpgroup's
      // shared tile, then 16-byte rows out.
      const int row0 = tl.m * kBM + wg * 64;
      const int g = lane / 4, q = lane % 4;
#pragma unroll
      for (int c = 0; c < kBN / 8; ++c) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;
          const bool ok = row0 + r < cnt;
          const float v0 = ok ? acc[4 * c + 2 * half] : 0.0f;
          const float v1 = ok ? acc[4 * c + 2 * half + 1] : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(epi + r * kEpiLd + 8 * c +
                                              2 * q) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      bf16* ye = y + (long long)tl.e * C * F;
      for (int i = tid; i < 64 * (kBN / 8); i += 128) {
        const int r = i / (kBN / 8), ch = i % (kBN / 8);
        const long long gr = row0 + r;
        const int gc = tl.n * kBN + ch * 8;
        if (gr < C && gc < F)
          *reinterpret_cast<uint4*>(ye + gr * F + gc) =
              *reinterpret_cast<const uint4*>(epi + r * kEpiLd + ch * 8);
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: take it from the runtime so
// that the library needs no -lcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over a row-major [n2, n1, n0] bf16 array, box [1, b1, b0],
// 128-byte swizzle, out-of-range elements read as zero.
bool encode_3d(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
               uint64_t n2, uint32_t b0, uint32_t b1) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {n0, n1, n2};
  cuuint64_t strides[2] = {n0 * 2, n0 * n1 * 2};
  cuuint32_t box[3] = {b0, b1, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kTransA, int kTransB>
cudaError_t run(const CUtensorMap& xmap, const CUtensorMap& wmap, bf16* y,
                const int* counts, int E, int C, int D, int F, int sms,
                cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tma_kernel<kTransA, kTransB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)E * ((C + kBM - 1) / kBM) *
                          ((F + kBN - 1) / kBN);
  const int blocks = (int)(tiles < sms ? tiles : sms);
  gmm_tma_kernel<kTransA, kTransB><<<blocks, kThreads, kSmemBytes, s>>>(
      xmap, wmap, y, counts, E, C, D, F);
  return cudaGetLastError();
}

// layout bit 0: x holds x^T [E, D, C]; bit 1: w holds w^T [E, F, D].
cudaError_t launch(const bf16* x, const bf16* w, bf16* y, const int* counts,
                   int E, int C, int D, int F, int layout, cudaStream_t s) {
  const bool ta = layout & 1, tb = layout & 2;
  if (D % 8 != 0 || F % 8 != 0 || D <= 0 || (ta && C % 8 != 0) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return cudaErrorInvalidValue;  // the wrapper's rule sends these to wmma
  CUtensorMap xmap, wmap;
  const bool ok_x = ta ? encode_3d(&xmap, x, C, D, E, 64, kBK)
                       : encode_3d(&xmap, x, D, C, E, kBK, kBM);
  const bool ok_w = tb ? encode_3d(&wmap, w, D, F, E, kBK, kBN)
                       : encode_3d(&wmap, w, F, D, E, 64, kBK);
  if (!ok_x || !ok_w) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (ta && tb) return run<1, 1>(xmap, wmap, y, counts, E, C, D, F, sms, s);
  if (ta) return run<1, 0>(xmap, wmap, y, counts, E, C, D, F, sms, s);
  if (tb) return run<0, 1>(xmap, wmap, y, counts, E, C, D, F, sms, s);
  return run<0, 0>(xmap, wmap, y, counts, E, C, D, F, sms, s);
}

}  // namespace tma

}  // namespace

// y[e] = x[e] @ w[e], rows >= counts[e] zero.  variant: 0 = simt (f32),
// 1 = wmma (bf16, any shape), 2 = tma (bf16, D and F multiples of 8,
// 16-byte aligned x, w and y).  layout (tma only, else 0): bit 0, x holds
// x^T [E, D, C] (C a multiple of 8); bit 1, w holds w^T [E, F, D].  counts
// may be null.  Returns the launch's cudaError_t; a variant that cannot
// take the shape returns cudaErrorInvalidValue without launching.
extern "C" int grouped_matmul(const void* x, const void* w, void* y,
                              const int* counts, int E, int C, int D, int F,
                              int variant, int layout, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout != 0 && variant != 2) return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    return (int)tma::launch(static_cast<const bf16*>(x),
                            static_cast<const bf16*>(w), static_cast<bf16*>(y),
                            counts, E, C, D, F, layout, s);
  } else if (variant == 1) {
    dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
    const bool x_vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool w_vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    gmm_bf16_kernel<<<grid, kThreadsBf16, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), counts, C, D, F, x_vec, w_vec);
  } else if (variant == 0) {
    dim3 grid((F + kFN - 1) / kFN, (C + kFM - 1) / kFM, E);
    gmm_f32_kernel<<<grid, kThreadsF32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), counts, C, D, F);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
