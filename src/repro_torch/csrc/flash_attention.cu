// Blockwise (flash) attention forward with GQA, causal masking and a sliding
// window, and optionally each row's log-sum-exp for the backward.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`, body `_flash_kernel`):
//   o[b, h] = softmax(q[b, h] k[b, h / g]^T * scale + mask) v[b, h / g]
// for q [B, H, S, D], k and v [B, K, S, D], g = H / K (GQA through the kv
// head index, no repeat), scale = 1 / sqrt(D), the mask the finite -1e30
// outside the causal band and the window, and the output
// acc / max(l, 1e-30) in q's dtype.  Every tensor is addressed through its
// own batch, head and sequence strides (in elements; each head row has unit
// stride), so q, k and v may be [B, S, H, D] memory seen as [B, H, S, D]
// and o is written wherever its strides point.
//
// Bound on the card: 4 * B * H * D operations for every visible (q, k)
// pair (two products of 2 * D each), at 989 TFLOP/s on the tensor cores in
// bf16 or 67 TFLOP/s of f32 FMAs, against reading q, k and v once and
// writing o once at 3.35 TB/s.  At the serving shapes (S >= 128, D >= 64)
// bf16 is bound by the operations and f32 far more so.  A window of w keys
// cuts the visible pairs from S^2 / 2 to about S * w.
//
// Design.  The TPU kernel walks a sequential kv grid axis, carries the
// running max, sum and accumulator in VMEM scratch across grid steps, and
// skips tiles outside the band with pl.when.  Here CUDA blocks run in no
// order, so one block owns one (q tile, batch * head), the blocks of the
// last q tiles (the most kv tiles under a causal mask) first, and loops over
// the kv tiles of 64 keys itself, from the first to the last tile that meets
// the band (`tile_range`): tiles outside it are never loaded.
//   bf16: a q tile of 128 rows, 4 warps of two 16-row blocks each, kv
//   tiles of 64 keys.  mma.sync m16n8k16 (bf16 in, f32 sums) computes
//   S = Q K^T from ldmatrix fragments, every k fragment serving both row
//   blocks of its warp (Q's fragments are read from shared memory again for
//   every tile, which keeps registers for the accumulators); the online
//   softmax runs on S's accumulator fragments, each row's max and sum
//   reduced over the 4 threads of a quad with __shfl_xor_sync; the
//   fragments of P then are the A operand of P V as they stand (the
//   accumulator layout of m16n8 is the A layout of m16k16), V's B fragments
//   come from ldmatrix.trans, each serving both row blocks and both terms
//   of P, and the f32 O accumulator is rescaled in registers (not at all
//   when no row's max moved).  Inside the band the scale folds into the
//   exponent's FMA, and 2^x is one ex2.approx: the softmax's instruction
//   count, not the products, set the pace of the first versions.  The TPU kernel multiplies f32 probabilities
//   by v, so P enters P V as two bf16 terms, hi = bf16(p) and lo = bf16(p -
//   hi), 16 bits of p: with P rounded to bf16 alone, an output of magnitude
//   4 or more lands a bf16 step away from the reference's.  That third
//   product per tile caps the kernel at about 2/3 of its bound.  k and v
//   tiles stream through two pairs of shared-memory buffers with cp.async:
//   the next tile's loads fly while the current tile's products run.  A
//   warp whose rows see no key of a tile skips its products.  Rows whose
//   addresses are not all 16-byte aligned (a head dim that is not a
//   multiple of 8, an odd stride) are loaded element by element with the
//   same zero fill; only the layout of the copy changes.  Measured on the
//   H100, the design is bound by latency rather than by one unit: its
//   products, shared-memory reads, L2 reads and instruction issue each
//   would take a third to a fifth of its time alone, and they overlap
//   little (two blocks of 4 warps an SM, 255 registers a thread).
//   f32: a q tile of 64 rows, 256 threads of plain f32 FMAs (no TF32), 4x4
//   scores and 4 x (D / 16) outputs a thread, the accumulator in
//   registers; the running max, sum and correction in shared memory.
// Masked scores are the reference's finite -1e30, not -inf: a row whose
// first tiles are all masked accumulates weights of exp(0) that the first
// visible score wipes (the correction exp(-1e30 - m) is 0), and every valid
// row meets its own diagonal (causal) or the keys at or after itself
// (window), so no row ends on garbage.  kv tiles go in ascending order.
// Any S >= 1: rows and keys past S are zero-filled and masked.  Any head dim
// up to 128 runs in the instance of the next width of 16, 32, 64 or 128, its
// extra columns zero-filled.
// Given an `lse` pointer (training), each row also stores the natural
// log-sum-exp of its scaled, masked scores, m + log(l), in f32 ([B, H, S]
// contiguous): the backward kernel (flash_attention_bwd.cu) recomputes the
// probabilities from it.  Serving passes none, and the store is skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBK = 64;   // keys of a kv tile (f32)

struct Strides {
  long long b, h, s;  // elements; the head dim has unit stride
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;         // [B, H, S] or null
  Strides sq, sk, sv, so;
  int B, H, K, S, d;  // d: the real head dim (<= the instance's DP)
  int n_qt;           // q tiles per (batch, head)
  int causal;
  int window;         // <= 0: no window
  float scale;
  int vec;            // every row may be copied in 16-byte vectors
};

// The kv tiles [lo, hi] of BK keys that meet the band of q rows
// [q0, q0 + BQ) ∩ [0, S): a tile is needed iff k_start <= q_end (causal)
// and k_end > q_start - window (window), as the TPU kernel's in_band test.
template <int BQ, int BK>
__device__ __forceinline__ void tile_range(const Params& p, int q0, int* lo,
                                           int* hi) {
  const int q_end = min(q0 + BQ, p.S) - 1;
  *hi = p.causal ? q_end / BK : (p.S - 1) / BK;
  *lo = 0;
  if (p.window > 0) {
    // (lo + 1) * BK - 1 > q0 - window  <=>  lo * BK >= q0 - window - BK + 2
    const int num = q0 - p.window - BK + 2;
    if (num > 0) *lo = (num + BK - 1) / BK;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  if (kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// The (q tile of BQ rows, batch * head) of this block: the last q tiles
// first.
template <int BQ>
__device__ __forceinline__ void block_coords(const Params& p, int* q0, int* b,
                                             int* h, int* kvh) {
  const int n_bh = p.B * p.H;
  const int bh = blockIdx.x % n_bh;
  *q0 = (p.n_qt - 1 - blockIdx.x / n_bh) * BQ;
  *b = bh / p.H;
  *h = bh % p.H;
  *kvh = *h / (p.H / p.K);
}

// Rows [row0, row0 + ROWS) of a [S, d] matrix with row stride `ss` into a
// [ROWS][LD] shared tile of DP columns, zero past S and past d, element by
// element (any alignment) or, with `vec`, in 16-byte vectors of whole rows
// (d == DP).
template <typename T, int ROWS, int DP, int LD, int kThreads>
__device__ void load_tile(T* s, const T* g, long long ss, int row0,
                          const Params& p) {
  constexpr int kVec = 16 / sizeof(T);
  if (p.vec && p.d == DP && LD % kVec == 0) {
    constexpr int kChunks = DP / kVec;
    for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < p.S)
        val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * ss +
                                              col);
      *reinterpret_cast<uint4*>(s + r * LD + col) = val;
    }
    return;
  }
  for (int c = threadIdx.x; c < ROWS * DP; c += kThreads) {
    const int r = c / DP, col = c % DP;
    T val = T(0.0f);
    if (row0 + r < p.S && col < p.d) val = g[(long long)(row0 + r) * ss + col];
    s[r * LD + col] = val;
  }
}

// ---- bf16: mma.sync m16n8k16, S, P and O in registers ---------------------

constexpr int kBQBf16 = 128;  // q rows of a block: 4 warps of 2 x 16
constexpr int kBKBf16 = 64;   // keys of a kv tile
constexpr int kRB = 2;        // 16-row blocks of a warp
constexpr int kThreadsBf16 = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(a))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(a))
      : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 in, f32 sums.  Not volatile: a pure
// function of its registers, which the compiler may interleave.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(p), lo = bf16(p - hi) of two neighbouring probabilities.
__device__ __forceinline__ void split(float p0, float p1, uint32_t* hi,
                                      uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  *hi = as_u32(h);
  *lo = as_u32(__floats2bfloat162_rn(p0 - __low2float(h),
                                     p1 - __high2float(h)));
}

// Rows [row0, row0 + ROWS) of a [S, d] bf16 matrix into a [ROWS][LD]
// shared tile, zero past S and past d: cp.async 16-byte chunks (d a
// multiple of 8, aligned rows), else element by element.
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_bf16(bf16* s, const bf16* g,
                                          long long ss, int row0,
                                          const Params& p) {
  if (p.vec) {
    constexpr int kChunks = DP / 8;
    for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreadsBf16) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool ok = row0 + r < p.S && col < p.d;
      cp_async16(s + r * LD + col, ok ? g + (long long)(row0 + r) * ss + col
                                      : g,
                 ok ? 16 : 0);
    }
  } else {
    load_tile<bf16, ROWS, DP, LD, kThreadsBf16>(s, g, ss, row0, p);
  }
}

// 2^x without the branches of exp2f; results below 2^-126 flush to 0 (such
// a weight is under 1e-38 of the row's largest).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
constexpr size_t bf16_smem_bytes() {
  return (size_t)(kBQBf16 + 4 * kBKBf16) * (DP + 8) *
         sizeof(bf16);  // q, then 2 x (k, v)
}

// Two blocks of 4 warps an SM.
template <int DP>
__global__ void __launch_bounds__(kThreadsBf16, 2)
flash_bf16_kernel(Params p) {
  constexpr int LD = DP + 8;  // 16-byte aligned rows, ldmatrix conflict-free
  constexpr int ND = DP / 8;  // n8 tiles of the output
  constexpr int BK = kBKBf16;
  constexpr int NS = BK / 8;  // n8 tiles of the scores
  constexpr int kTile = BK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQBf16 * LD;  // [2][BK][LD]
  bf16* Vs = Ks + 2 * kTile;     // [2][BK][LD]

  int q0, b, h, kvh;
  block_coords<kBQBf16>(p, &q0, &b, &h, &kvh);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  bf16* og = static_cast<bf16*>(p.o) + b * p.so.b + h * p.so.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 * kRB;  // this warp's 32 rows of the q tile
  const int qa = q0 + r0, qb = qa + 16 * kRB - 1;  // their positions
  const float scale = p.scale * kLog2e;  // scores in log2 units

  int lo, hi;
  tile_range<kBQBf16, BK>(p, q0, &lo, &hi);
  load_bf16<kBQBf16, DP, LD>(Qs, qg, p.sq.s, q0, p);
  load_bf16<BK, DP, LD>(Ks, kg, p.sk.s, lo * BK, p);
  load_bf16<BK, DP, LD>(Vs, vg, p.sv.s, lo * BK, p);
  cp_async_commit();

  float o[kRB][ND][4];
#pragma unroll
  for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[rb][n][i] = 0.0f;
  // rows g and g + 8 of each row block: running max (log2 units) and this
  // thread's share of the sums
  float m_run[kRB][2], l_run[kRB][2];
#pragma unroll
  for (int rb = 0; rb < kRB; ++rb) {
    m_run[rb][0] = m_run[rb][1] = kNegInf;
    l_run[rb][0] = l_run[rb][1] = 0.0f;
  }

  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * BK;
    const int buf = (jt - lo) & 1;
    if (jt < hi) {  // the next tile flies while this one is multiplied
      load_bf16<BK, DP, LD>(Ks + (buf ^ 1) * kTile, kg, p.sk.s, k0 + BK, p);
      load_bf16<BK, DP, LD>(Vs + (buf ^ 1) * kTile, vg, p.sv.s, k0 + BK, p);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile jt is in
    const bf16* Kb = Ks + buf * kTile;
    const bf16* Vb = Vs + buf * kTile;

    // A warp whose rows see no key of this tile (all past S, all before
    // it, or all after the window) skips its products: they would add
    // nothing that survives (masked weights are 0 once a row has seen a
    // visible key, and every row sees one later).
    const bool skip = qa >= p.S || (p.causal && k0 > qb) ||
                      (p.window > 0 && k0 + BK - 1 <= qa - p.window);
    if (!skip) {
      // S = Q K^T: per row block [16, BK], NS n8 tiles of 4 values a
      // thread.  Each k fragment serves both row blocks.
      float s[kRB][NS][4];
#pragma unroll
      for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[rb][j][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qf[kRB][4];
#pragma unroll
        for (int rb = 0; rb < kRB; ++rb)
          ldmatrix_x4(qf[rb], Qs + (r0 + 16 * rb + lane % 8 +
                                    8 * ((lane / 8) % 2)) * LD +
                                  kk * 16 + 8 * (lane / 16));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kb + (np * 16 + lane % 8 + 8 * (lane / 16)) * LD +
                              kk * 16 + 8 * ((lane / 8) % 2));
#pragma unroll
          for (int rb = 0; rb < kRB; ++rb) {
            mma_bf16(s[rb][2 * np], qf[rb], kf[0], kf[1]);
            mma_bf16(s[rb][2 * np + 1], qf[rb], kf[2], kf[3]);
          }
        }
      }

      // Online softmax on the fragments: value i of tile j in row block rb
      // is row r0 + 16 * rb + g + 8 * (i / 2), key k0 + 8 * j + 2 * t +
      // i % 2.  A row block wholly inside the band needs no mask.
#pragma unroll
      for (int rb = 0; rb < kRB; ++rb) {
        const int qr = qa + 16 * rb;
        const bool inside = k0 + BK <= p.S &&
                            (!p.causal || k0 + BK - 1 <= qr) &&
                            (p.window <= 0 || k0 > qr + 15 - p.window);
        // the max of the scaled scores is the scaled max of the raw ones
        // (scale > 0), so inside the band the scale folds into one FMA
        float mx[2] = {kNegInf, kNegInf};
        if (inside) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[rb][j][i]);
          mx[0] *= scale;
          mx[1] *= scale;
        } else {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int qpos = qr + g + 8 * (i / 2);
              const int kpos = k0 + 8 * j + 2 * t + i % 2;
              const float x =
                  visible(p, qpos, kpos) ? s[rb][j][i] * scale : kNegInf;
              s[rb][j][i] = x;
              mx[i / 2] = fmaxf(mx[i / 2], x);
            }
          }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], m_run[rb][r]);
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2_ftz(m_run[rb][r] - mx[r]);
          m_run[rb][r] = mx[r];
        }
        float sum[2] = {0.0f, 0.0f};
        const float sc = inside ? scale : 1.0f;  // outside: already scaled
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[rb][j][i] =
                exp2_ftz(fmaf(s[rb][j][i], sc, -m_run[rb][i / 2]));
            sum[i / 2] += s[rb][j][i];
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l_run[rb][r] = l_run[rb][r] * corr[r] + sum[r];
        // no row of the block moved its max: its accumulator stays
        if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            o[rb][n][0] *= corr[0];
            o[rb][n][1] *= corr[0];
            o[rb][n][2] *= corr[1];
            o[rb][n][3] *= corr[1];
          }
        }
      }

      // O += P V, P as hi + lo bf16 A fragments built from S's fragments;
      // each v fragment serves both row blocks and both terms.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[kRB][4], pl[kRB][4];
#pragma unroll
        for (int rb = 0; rb < kRB; ++rb) {
          split(s[rb][2 * kk][0], s[rb][2 * kk][1], &ph[rb][0], &pl[rb][0]);
          split(s[rb][2 * kk][2], s[rb][2 * kk][3], &ph[rb][1], &pl[rb][1]);
          split(s[rb][2 * kk + 1][0], s[rb][2 * kk + 1][1], &ph[rb][2],
                &pl[rb][2]);
          split(s[rb][2 * kk + 1][2], s[rb][2 * kk + 1][3], &ph[rb][3],
                &pl[rb][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vb + (kk * 16 + lane % 8 +
                                      8 * ((lane / 8) % 2)) * LD +
                                    dp * 16 + 8 * (lane / 16));
#pragma unroll
          for (int rb = 0; rb < kRB; ++rb) {
            mma_bf16(o[rb][2 * dp], pl[rb], vf[0], vf[1]);
            mma_bf16(o[rb][2 * dp + 1], pl[rb], vf[2], vf[3]);
          }
#pragma unroll
          for (int rb = 0; rb < kRB; ++rb) {
            mma_bf16(o[rb][2 * dp], ph[rb], vf[0], vf[1]);
            mma_bf16(o[rb][2 * dp + 1], ph[rb], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }
  cp_async_wait<0>();

  // Each row's log-sum-exp, for the backward, before the output: the scores
  // are dead here and the running max dies with it.  m and log2(l) are in
  // log2 units, so the natural lse is their sum times ln 2.
  if (p.lse != nullptr) {
#pragma unroll
    for (int rb = 0; rb < kRB; ++rb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[rb][r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int qpos = qa + 16 * rb + g + 8 * r;
        if (t == 0 && qpos < p.S)
          p.lse[((long long)b * p.H + h) * p.S + qpos] =
              (m_run[rb][r] + log2f(l)) * 0.6931471805599453f;
      }
  }

  // o / max(l, 1e-30) in bf16, one row block at a time.
#pragma unroll
  for (int rb = 0; rb < kRB; ++rb) {
    const int qr = qa + 16 * rb;
    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l_run[rb][r];
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    if (p.vec) {
      // this row block's rows of the q tile hold its output, then 16-byte
      // stores
      bf16* os = Qs + (r0 + 16 * rb) * LD;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(os + g * LD + 8 * n + 2 * t) =
            __floats2bfloat162_rn(o[rb][n][0] / l[0], o[rb][n][1] / l[0]);
        *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + 8 * n +
                                            2 * t) =
            __floats2bfloat162_rn(o[rb][n][2] / l[1], o[rb][n][3] / l[1]);
      }
      __syncwarp();
      for (int c = lane; c < 16 * ND; c += 32) {
        const int r = c / ND, col = (c % ND) * 8;
        const int qpos = qr + r;
        if (qpos < p.S && col < p.d)
          *reinterpret_cast<uint4*>(og + (long long)qpos * p.so.s + col) =
              *reinterpret_cast<const uint4*>(os + r * LD + col);
      }
    } else {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qpos = qr + g + 8 * (i / 2);
          const int col = 8 * n + 2 * t + i % 2;
          if (qpos < p.S && col < p.d)
            og[(long long)qpos * p.so.s + col] =
                __float2bfloat16(o[rb][n][i] / l[i / 2]);
        }
      }
    }
  }
}

// ---- f32: SIMT FMAs, no TF32 ---------------------------------------------

constexpr int kBQF32 = 64;  // q rows of a block
constexpr int kThreadsF32 = 256;

template <int DP>
constexpr size_t f32_smem_bytes() {
  return (size_t)kBQF32 * DP * sizeof(float)           // q tile
         + (size_t)kBK * (DP + 1) * sizeof(float)   // k tile, padded rows
         + (size_t)kBK * DP * sizeof(float)         // v tile
         + (size_t)kBQF32 * (kBK + 1) * sizeof(float)  // scores, probabilities
         + (size_t)3 * kBQF32 * sizeof(float);         // max, sum, correction
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_f32_kernel(Params p) {
  constexpr int LDK = DP + 1;   // conflict-free reads down a key column
  constexpr int LDS = kBK + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQF32 * DP;
  float* Vs = Ks + kBK * LDK;
  float* Ss = Vs + kBK * DP;
  float* row_m = Ss + kBQF32 * LDS;
  float* row_l = row_m + kBQF32;
  float* row_c = row_l + kBQF32;

  int q0, b, h, kvh;
  block_coords<kBQF32>(p, &q0, &b, &h, &kvh);
  const float* qg = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kg = static_cast<const float*>(p.k) + b * p.sk.b +
                    kvh * p.sk.h;
  const float* vg = static_cast<const float*>(p.v) + b * p.sv.b +
                    kvh * p.sv.h;
  float* og = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;
  // rows ty * 4 + i; score columns and output columns tx + 16 * j
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<float, kBQF32, DP, DP, kThreadsF32>(Qs, qg, p.sq.s, q0, p);
  if (threadIdx.x < kBQF32) {
    row_m[threadIdx.x] = kNegInf;
    row_l[threadIdx.x] = 0.0f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  int lo, hi;
  tile_range<kBQF32, kBK>(p, q0, &lo, &hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's k, v and probabilities are read
    load_tile<float, kBK, DP, LDK, kThreadsF32>(Ks, kg, p.sk.s, k0, p);
    load_tile<float, kBK, DP, DP, kThreadsF32>(Vs, vg, p.sv.s, k0, p);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < DP; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LDK + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // Online softmax: four threads a row, 16 keys each.
    {
      const int r = threadIdx.x / 4, c0 = (threadIdx.x % 4) * 16;
      const int qpos = q0 + r;
      float* srow = Ss + r * LDS;
      float mx = kNegInf;
      for (int c = c0; c < c0 + 16; ++c) {
        const float v = visible(p, qpos, k0 + c) ? srow[c] * p.scale : kNegInf;
        srow[c] = v;
        mx = fmaxf(mx, v);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = c0; c < c0 + 16; ++c) {
        const float e = expf(srow[c] - m_new);
        srow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_prev - m_new);
      __syncwarp();  // the row's four threads have read row_m[r]
      if (threadIdx.x % 4 == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * corr + sum;
        row_c[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kBK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float v = Vs[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], v, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qpos = q0 + r;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (qpos < p.S && c < p.d)
        og[(long long)qpos * p.so.s + c] = acc[i][j] / l;
    }
  }
  // each row's log-sum-exp, for the backward, once the accumulator is dead
  if (p.lse != nullptr && threadIdx.x < kBQF32 && q0 + threadIdx.x < p.S)
    p.lse[((long long)b * p.H + h) * p.S + q0 + threadIdx.x] =
        row_m[threadIdx.x] + logf(row_l[threadIdx.x]);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, unsigned blocks,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

Strides strides_at(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// o = attention(q, k, v) for q, o [B, H, S, D] and k, v [B, K, S, D], each
// given by its base and its (batch, head, sequence) strides in elements
// (`strides`: q's three, then k's, v's and o's); the head dim has unit
// stride.  causal: 0 or 1; window <= 0: none.  dtype: 0 = float32,
// 1 = bfloat16.  1 <= D <= 128.  lse: null, or [B, H, S] f32 for each row's
// log-sum-exp.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, int B,
                               int H, int K, int S, int D, int causal,
                               int window, float scale, int dtype, float* lse,
                               void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  const int dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sq = strides_at(strides);
  p.sk = strides_at(strides + 3);
  p.sv = strides_at(strides + 6);
  p.so = strides_at(strides + 9);
  p.B = B;
  p.H = H;
  p.K = K;
  p.S = S;
  p.d = D;
  const int bq = dtype == 1 ? kBQBf16 : kBQF32;
  p.n_qt = (S + bq - 1) / bq;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  // 16-byte vectors need aligned bases and strides and whole 16-byte chunks
  // of each row
  const int per16 = dtype == 1 ? 8 : 4;
  bool vec = D % per16 == 0 &&
             (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v) |
              reinterpret_cast<uintptr_t>(o)) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % per16 == 0;
  p.vec = vec;
  const long long blocks = (long long)B * H * p.n_qt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned nb = (unsigned)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (dp) {
      case 16:
        return (int)launch(flash_bf16_kernel<16>, kThreadsBf16,
                           bf16_smem_bytes<16>(), nb, p, s);
      case 32:
        return (int)launch(flash_bf16_kernel<32>, kThreadsBf16,
                           bf16_smem_bytes<32>(), nb, p, s);
      case 64:
        return (int)launch(flash_bf16_kernel<64>, kThreadsBf16,
                           bf16_smem_bytes<64>(), nb, p, s);
      default:
        return (int)launch(flash_bf16_kernel<128>, kThreadsBf16,
                           bf16_smem_bytes<128>(), nb, p, s);
    }
  }
  if (dtype == 0) {
    switch (dp) {
      case 16:
        return (int)launch(flash_f32_kernel<16>, kThreadsF32,
                           f32_smem_bytes<16>(), nb, p, s);
      case 32:
        return (int)launch(flash_f32_kernel<32>, kThreadsF32,
                           f32_smem_bytes<32>(), nb, p, s);
      case 64:
        return (int)launch(flash_f32_kernel<64>, kThreadsF32,
                           f32_smem_bytes<64>(), nb, p, s);
      default:
        return (int)launch(flash_f32_kernel<128>, kThreadsF32,
                           f32_smem_bytes<128>(), nb, p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}
