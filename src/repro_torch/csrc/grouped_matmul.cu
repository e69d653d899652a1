// Grouped (per-expert) matrix product for the MoE expert FFN.
//
// Replaces the Pallas TPU kernel src/repro/kernels/grouped_matmul/
// grouped_matmul.py (`grouped_matmul`, body `_gmm_kernel`):
//   y[e] = x[e] @ w[e]   for x [E, C, D], w [E, D, F], f32 accumulation,
//   rows >= counts[e] written as 0 (counts == nullptr: every row is valid).
//
// Bound on the card: at the MoE shapes (C of a few hundred rows per expert,
// D = 2048, F = 8192) the product needs 2*E*C*D*F operations against
// E*D*F weights, i.e. about C operations per weight byte in bf16: prefill
// (C = 768) sits above the H100's ~295 op/byte ridge and is bound by the
// tensor cores (989 TFLOP/s bf16); decode (C = 256) sits below it and is bound
// by reading the weights (3.35 TB/s).  The design answers the first with
// tensor cores (WMMA 16x16x16 bf16 fragments, f32 accumulators) on a
// 128x128x32 block tile shared by 8 warps, and the second by reading each
// weight tile through 16-byte vectors and skipping every row tile that lies
// wholly past counts[e]: such a tile runs no K loop and only writes zeros.
// f32 inputs take a SIMT path (64x64x16 tiles, 4x4 outputs a thread) with
// plain f32 FMAs, so no TF32 rounding enters.  Ragged edges are masked: C, D
// and F need not divide any tile.  No TMA, wgmma or software pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16: WMMA on tensor cores ------------------------------------------

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

}  // namespace

// y[e] = x[e] @ w[e], rows >= counts[e] zero.  dtype: 0 = float32,
// 1 = bfloat16.  counts may be null.  Returns the launch's cudaError_t.
extern "C" int grouped_matmul(const void* x, const void* w, void* y,
                              const int* counts, int E, int C, int D, int F,
                              int dtype, void* stream) {
  if (E <= 0 || C <= 0 || F <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
    const bool x_vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool w_vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    gmm_bf16_kernel<<<grid, kThreadsBf16, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), counts, C, D, F, x_vec, w_vec);
  } else if (dtype == 0) {
    dim3 grid((F + kFN - 1) / kFN, (C + kFM - 1) / kFM, E);
    gmm_f32_kernel<<<grid, kThreadsF32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), counts, C, D, F);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
