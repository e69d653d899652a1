// Backward of the blockwise (flash) attention with GQA, causal masking and a
// sliding window.
//
// Replaces nothing on the TPU side: the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`,
// pallas_call at :122) is forward only, and the reference trains through
// the gradient of its einsum attention (src/repro/models/layers.py).  The
// port's forward runs on flash_attention.cu, so its gradient is this
// kernel, FA2's recompute:
//   P = exp(S * scale - lse)            (lse from the forward, per q row)
//   delta = rowsum(dO * O)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// for q, o, dO, dq [B, H, S, D] and k, v, dk, dv [B, K, S, D], the kv head of
// query head h being h / (H / K): dK and dV of a kv head sum over its H / K
// query heads.  The mask is the forward's exactly: causal, the window, rows
// and keys past S.  Every tensor is addressed through its own batch, head
// and sequence strides (in elements, the head dim at unit stride).
//
// Bound on the card: 10 * D operations for every visible (q, k) pair and
// head (the forward's two products of 2 * D again for S and dP, and three
// more for dV, dK, dQ, less the forward's P V), at 989 TFLOP/s in bf16 on
// the tensor cores, against reading q, k, v, o, dO and lse once and writing
// dq, dk, dv once at 3.35 TB/s, whichever is larger.  At the training
// shapes it is bound by the bytes (D = 64, S = 512) or close to the line;
// at mixtral's long shape by the operations.
//
// Deterministic, no atomics: two passes, each output written by one block,
// every sum taken in a fixed order, so a backward run twice gives the same
// bits.  Both passes recompute S and dP, so together they do 14 * D
// operations per pair (S and dP twice, dV, dK, dQ once): at best about 70%
// of the bound above.  One pass with dQ summed across blocks would need
// atomics, whose order changes from run to run.
//
// Two instances, picked by the wrapper's rule (`variant`), never as a
// fallback:
//
// wgmma (bf16, D a multiple of 8 up to 128, every base and every batch,
//   head and sequence stride of q, k, v, o and dO on 16 bytes): Hopper's
//   tensor cores.  Three kernels on the stream:
//   1. prep: rowsum(dO * O) in f32 and lse * log2(e), 16-byte loads, into
//      a [2, B * H, S_pad] scratch (S_pad = S rounded up to 128; zeros past
//      S), so that a tile's vectors are one bulk copy;
//   2. dK, dV: one block per (128 keys, batch * kv head), the first kv
//      tiles (the most q tiles under a causal mask) first.  A block is one
//      producer warp and two consumer warpgroups of 64 keys each.  The
//      producer (its registers lowered with setmaxnreg) loads the block's
//      K and V once and streams, for every query head of the group and
//      every q tile of 64 rows that meets the band, Q, dO (TMA through 4-D
//      tensor maps over [B, heads, S, D] with the tensors' own strides,
//      128-byte swizzle, zero past S and past D) and the tile's lse and
//      delta (cp.async.bulk) through a ring of 3 stages with a full and an
//      empty mbarrier each.  A consumer warpgroup runs, per q tile,
//        S^T = K Q^T and dP^T = V dO^T   wgmma m64n64k16, K and V the
//                                        shared A operand, Q and dO the
//                                        K-major B operand;
//        P^T = 2^(S^T * scale * log2 e - lse2) and dS^T = P^T (dP^T -
//        delta) in registers, lse2 and delta per column (P^T while dP^T's
//        products still run), the mask (an interval of q rows per key)
//        only on tiles the band's edge cuts;
//        dV += P^T dO and dK += dS^T Q    wgmma m64nDk16, P^T and dS^T as
//                                        bf16 register A operands (the
//                                        accumulator's layout is the A
//                                        layout), dO and Q read N-major
//                                        through the B transpose bit;
//      its f32 dK and dV stay in registers across the whole group.  A
//      warpgroup whose 64 keys see no row of a tile skips its products.
//   3. dQ: one block per (128 q rows, batch * head), the last q tiles
//      first; the producer loads the block's Q, dO, lse and delta once and
//      streams the K and V tiles of 64 keys in the band (the forward's tile
//      range; tiles outside it are never loaded); per tile a warpgroup of
//      64 rows runs S = Q K^T and dP = dO V^T, dS in registers, and
//      dQ += dS K with dS the register A operand and K read N-major.
//   P and dS enter their products as bf16 (f32 sums), as in FA2 and FA3:
//   the gate is relative to the largest reference gradient, so one
//   rounding of each is within it.  A D of up to 64 runs in the 64-column
//   instance, up to 128 in the 128-column one; TMA zero-fills the columns
//   past D.
// simt (f32; bf16 that the wgmma rule refuses): the first design, plain
//   f32 FMAs, three kernels:
//   1. delta: one warp per q row, rowsum(dO * O) in f32 into a scratch
//      [B, H, S];
//   2. dK, dV: one block per (kv tile of 64 keys, batch * kv head), the
//      heaviest tiles (the first, under a causal mask) first; the k and v
//      tiles stay in shared memory while the block walks every q tile of
//      64 rows that meets the band, for each of the kv head's query heads,
//      and sums dK and dV in registers;
//   3. dQ: one block per (q tile of 64 rows, batch * head), the last q tiles
//      first; q, dO, lse and delta stay in shared memory while the block
//      walks the kv tiles in the band (the forward's tile range) and sums dQ
//      in registers.
//   Each block is 256 threads of plain f32 FMAs (no TF32, no tensor cores),
//   inputs converted to f32 in shared memory: a thread computes a 4 x 4
//   patch of S and dP (q rows ty * 4 + i, keys tx + 16 * j) and 4 rows of
//   D / 16 columns of its accumulators.  Any S >= 1 and any head dim up to
//   128, in the instance of the next width of 16, 32, 64 or 128, extra
//   columns zero-filled.  f32 and bf16 inputs; every sum is f32, the
//   results are stored in the inputs' dtype.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // q rows of a tile
constexpr int kBK = 64;  // keys of a tile
constexpr int kThreads = 256;

struct Strides {
  long long b, h, s;  // elements; the head dim has unit stride
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, S]
  float* delta;      // [B, H, S] scratch
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, K, S, d;
  int n_qt, n_kt;  // tiles of 64 along S
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// The forward's mask, rows past S included.
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  if (qpos >= p.S || kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// Rows [row0, row0 + ROWS) of a [S, d] matrix with row stride `ss` as f32
// into a [ROWS][LD] shared tile of DP columns, zero past S and past d.
template <typename T, int ROWS, int DP, int LD>
__device__ void load_f32(float* s, const T* g, long long ss, int row0,
                         const Params& p) {
  for (int c = threadIdx.x; c < ROWS * DP; c += kThreads) {
    const int r = c / DP, col = c % DP;
    float val = 0.0f;
    if (row0 + r < p.S && col < p.d)
      val = to_f(g[(long long)(row0 + r) * ss + col]);
    s[r * LD + col] = val;
  }
}

// lse and delta of q rows [q0, q0 + kBQ) of row `bh` (b * H + h).
__device__ void load_rows(float* lse_s, float* delta_s, const Params& p,
                          long long bh, int q0) {
  if (threadIdx.x < kBQ) {
    const int qpos = q0 + threadIdx.x;
    const bool ok = qpos < p.S;
    lse_s[threadIdx.x] = ok ? p.lse[bh * p.S + qpos] : 0.0f;
    delta_s[threadIdx.x] = ok ? p.delta[bh * p.S + qpos] : 0.0f;
  }
}

// P and dS of the (q tile at q0, kv tile at k0) pair: S = Q K^T and
// dP = dO V^T from the shared tiles, then P = exp(S * scale - lse) on
// visible pairs (else 0) and dS = P * (dP - delta).  Writes dS (and P, when
// Ps is given) as [kBQ][kBK + 1] shared tiles.
template <int DP>
__device__ __forceinline__ void probs_and_ds(const Params& p, const float* Qs,
                                             const float* dOs,
                                             const float* Ks,
                                             const float* Vs,
                                             const float* lse_s,
                                             const float* delta_s, int q0,
                                             int k0, float* Ps, float* dSs) {
  constexpr int LDK = DP + 1;
  constexpr int LDS = kBK + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
  for (int c = 0; c < DP; ++c) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * DP + c];
      g[i] = dOs[(ty * 4 + i) * DP + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = Ks[(tx + 16 * j) * LDK + c];
      bv[j] = Vs[(tx + 16 * j) * LDK + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float pr =
          visible(p, q0 + r, k0 + c) ? expf(s[i][j] * p.scale - lse_s[r])
                                     : 0.0f;
      if (Ps != nullptr) Ps[r * LDS + c] = pr;
      dSs[r * LDS + c] = pr * (dp[i][j] - delta_s[r]);
    }
  }
}

// ---- 1. delta = rowsum(dO * O) -------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_delta_kernel(Params p) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.H * p.S) return;
  const int s = (int)(row % p.S);
  const long long bh = row / p.S;
  const int h = (int)(bh % p.H), b = (int)(bh / p.H);
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h +
               s * p.so.s;
  const T* g = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h +
               s * p.sdo.s;
  float acc = 0.0f;
  for (int c = lane; c < p.d; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// ---- 2. dK, dV ------------------------------------------------------------

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return ((size_t)2 * kBK * (DP + 1)     // k, v
          + (size_t)2 * kBQ * DP         // q, dO
          + (size_t)2 * kBQ * (kBK + 1)  // P, dS
          + (size_t)2 * kBQ) *           // lse, delta
         sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) bwd_dkdv_kernel(Params p) {
  constexpr int LDK = DP + 1;
  constexpr int LDS = kBK + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kBK * LDK;
  float* Qs = Vs + kBK * LDK;
  float* dOs = Qs + kBQ * DP;
  float* Ps = dOs + kBQ * DP;
  float* dSs = Ps + kBQ * LDS;
  float* lse_s = dSs + kBQ * LDS;
  float* delta_s = lse_s + kBQ;

  const int n_bk = p.B * p.K;
  const int kt = blockIdx.x / n_bk;  // the first kv tiles (most work) first
  const int b = (blockIdx.x % n_bk) / p.K;
  const int kvh = (blockIdx.x % n_bk) % p.K;
  const int k0 = kt * kBK;
  const int group = p.H / p.K;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_f32<T, kBK, DP, LDK>(
      Ks, static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h, p.sk.s, k0,
      p);
  load_f32<T, kBK, DP, LDK>(
      Vs, static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h, p.sv.s, k0,
      p);

  // q tiles that see a key of this tile: q >= k0 (causal) and
  // q <= k_last + window - 1 (window)
  const int q_lo = p.causal ? k0 / kBQ : 0;
  int q_hi = p.n_qt - 1;
  if (p.window > 0) {
    const long long last = (long long)min(k0 + kBK, p.S) - 1 + p.window - 1;
    if (last / kBQ < q_hi) q_hi = (int)(last / kBQ);
  }

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const long long bh = (long long)b * p.H + h;
    const T* qg = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* dog = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
    for (int qt = q_lo; qt <= q_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the last tile's q, dO, P and dS are read
      load_f32<T, kBQ, DP, DP>(Qs, qg, p.sq.s, q0, p);
      load_f32<T, kBQ, DP, DP>(dOs, dog, p.sdo.s, q0, p);
      load_rows(lse_s, delta_s, p, bh, q0);
      __syncthreads();
      probs_and_ds<DP>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, Ps, dSs);
      __syncthreads();
      // dV[key] += P[:, key]^T dO, dK[key] += dS[:, key]^T Q: keys
      // ty * 4 + i, columns tx + 16 * c
      for (int r = 0; r < kBQ; ++r) {
        float pr[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = Ps[r * LDS + ty * 4 + i];
          ds[i] = dSs[r * LDS + ty * 4 + i];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float g = dOs[r * DP + tx + 16 * c];
          const float a = Qs[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pr[i], g, dv[i][c]);
            dk[i][c] = fmaf(ds[i], a, dk[i][c]);
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  T* dvg = static_cast<T*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= p.S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) {
        dkg[(long long)kpos * p.sdk.s + col] = from_f<T>(dk[i][c] * p.scale);
        dvg[(long long)kpos * p.sdv.s + col] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// ---- 3. dQ ----------------------------------------------------------------

template <int DP>
constexpr size_t dq_smem_bytes() {
  return ((size_t)2 * kBK * (DP + 1)  // k, v
          + (size_t)2 * kBQ * DP      // q, dO
          + (size_t)kBQ * (kBK + 1)   // dS
          + (size_t)2 * kBQ) *        // lse, delta
         sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 1) bwd_dq_kernel(Params p) {
  constexpr int LDK = DP + 1;
  constexpr int LDS = kBK + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kBK * LDK;
  float* Qs = Vs + kBK * LDK;
  float* dOs = Qs + kBQ * DP;
  float* dSs = dOs + kBQ * DP;
  float* lse_s = dSs + kBQ * LDS;
  float* delta_s = lse_s + kBQ;

  const int n_bh = p.B * p.H;
  const int qt = p.n_qt - 1 - blockIdx.x / n_bh;  // the last q tiles first
  const int bhi = blockIdx.x % n_bh;
  const int b = bhi / p.H, h = bhi % p.H;
  const int kvh = h / (p.H / p.K);
  const int q0 = qt * kBQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_f32<T, kBQ, DP, DP>(
      Qs, static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p);
  load_f32<T, kBQ, DP, DP>(
      dOs, static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h,
      p.sdo.s, q0, p);
  load_rows(lse_s, delta_s, p, (long long)b * p.H + h, q0);
  const T* kg = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;

  // the kv tiles that meet the band of rows [q0, q0 + kBQ), as the forward
  const int q_end = min(q0 + kBQ, p.S) - 1;
  const int hi = p.causal ? q_end / kBK : (p.S - 1) / kBK;
  int lo = 0;
  if (p.window > 0) {
    const int num = q0 - p.window - kBK + 2;
    if (num > 0) lo = (num + kBK - 1) / kBK;
  }

  float dq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.0f;

  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's k and dS are read
    load_f32<T, kBK, DP, LDK>(Ks, kg, p.sk.s, k0, p);
    load_f32<T, kBK, DP, LDK>(Vs, vg, p.sv.s, k0, p);
    __syncthreads();
    probs_and_ds<DP>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, nullptr,
                     dSs);
    __syncthreads();
    // dQ[row] += dS[row, :] K: rows ty * 4 + i, columns tx + 16 * c
    for (int j = 0; j < kBK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = Ks[j * LDK + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(ds[i], kv, dq[i][c]);
      }
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= p.S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d)
        dqg[(long long)qpos * p.sdq.s + col] = from_f<T>(dq[i][c] * p.scale);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, unsigned blocks,
                   const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t run(const Params& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.S;
  const long long n_delta = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const long long n_dkdv = (long long)p.n_kt * p.B * p.K;
  const long long n_dq = (long long)p.n_qt * p.B * p.H;
  if (n_delta > 0x7fffffffLL || n_dkdv > 0x7fffffffLL || n_dq > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err =
      launch(bwd_delta_kernel<T>, 0, (unsigned)n_delta, p, stream);
  if (err != cudaSuccess) return err;
  err = launch(bwd_dkdv_kernel<T, DP>, dkdv_smem_bytes<DP>(),
               (unsigned)n_dkdv, p, stream);
  if (err != cudaSuccess) return err;
  return launch(bwd_dq_kernel<T, DP>, dq_smem_bytes<DP>(), (unsigned)n_dq, p,
                stream);
}

template <typename T>
cudaError_t run_width(const Params& p, cudaStream_t stream) {
  if (p.d <= 16) return run<T, 16>(p, stream);
  if (p.d <= 32) return run<T, 32>(p, stream);
  if (p.d <= 64) return run<T, 64>(p, stream);
  return run<T, 128>(p, stream);
}

Strides strides_at(const long long* s) { return Strides{s[0], s[1], s[2]}; }

// ---- bf16 on Hopper: TMA ring, wgmma, warp-specialised -------------------

namespace wg {

constexpr int kTile = 64;         // rows of a streamed tile and of a
                                  // warpgroup's share of a block
constexpr int kConsumers = 2;     // warpgroups of 64 stationary rows
constexpr int kRows = kTile * kConsumers;  // a block's stationary rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 3;
constexpr int kBox = kTile * 128;  // one TMA box: 64 rows x 64 columns
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block (offsets from a 1024-byte aligned base): two
// stationary tiles of kRows x DP, the ring of kStages pairs of streamed
// tiles of kTile x DP, then f32 vectors (the stationary lse2 and delta of
// kRows each, then each stage's lse2 and delta of kTile each) and the
// mbarriers.  A tile of R rows is DP / 64 column halves of R rows of 128
// bytes, each in TMA's 128-byte swizzle.
template <int DP>
struct Smem {
  static constexpr int kStatTile = kRows * DP * 2;
  static constexpr int kRingTile = kTile * DP * 2;
  static constexpr int kRing = 2 * kStatTile;
  static constexpr int kVec = kRing + kStages * 2 * kRingTile;
  static constexpr int kBar = kVec + (2 * kRows + 2 * kStages * kTile) * 4;
  static constexpr int kBytes = 1024 + kBar + (1 + 2 * kStages) * 8;
};

struct Params {
  const float* lse2;   // [B * H, S_pad]: lse * log2(e), 0 past S
  const float* delta;  // [B * H, S_pad]: rowsum(dO * O), 0 past S
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides sdq, sdk, sdv;
  int B, H, K, S, S_pad, d;
  int causal;
  int window;  // <= 0: no window
  float scale, scale_log2;
};

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

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Rows [row0, row0 + ROWS) of head `head`, batch `b` of a 4-D map into a
// [ROWS x DP] tile at `dst`: DP / 64 column halves of ROWS / 64 boxes.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row0, int head,
                                          int b) {
#pragma unroll
  for (int h = 0; h < DP / 64; ++h)
#pragma unroll
    for (int r = 0; r < ROWS / kTile; ++r)
      tma_load_4d(dst + h * ROWS * 128 + r * kBox, map, bar, h * 64,
                  row0 + r * kTile, head, b);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (the head dim contiguous) of 64 rows, the `block`-th 64
// rows of a tile of ROWS rows at `base`, k-step kk (16 columns): 32 bytes
// along the swizzled row, the column half kk / 4; 8-row groups 1024 bytes
// apart.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int block, int kk) {
  return sw128_desc(base + (kk / 4) * ROWS * 128 + block * kBox +
                        (kk % 4) * 32,
                    16, 1024);
}

// N-major B operand (the head dim as N) of a kTile-row tile at `base`,
// k-step kk (16 rows = two 8-row groups of 1024 bytes); the next 64 columns
// one box on.
__device__ __forceinline__ uint64_t nmajor(uint32_t base, int kk) {
  return sw128_desc(base + kk * 2048, kBox, 1024);
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

// Keeps the compiler from moving reads or writes of registers that wgmma
// uses across its issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64x64] (+)= a[64x16] b[16x64], both K-major in shared memory; d is
// overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x64] += a[64x16] b[16x64]: a from registers (four bf16 pairs in
// the accumulator's layout), b N-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d[64x128] += a[64x16] b[16x128]: a from registers (four bf16 pairs in
// the accumulator's layout), b N-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
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
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// acc[64 x DP] += a[64 x 64] b[64 x DP]: a from registers (16 bf16 pairs,
// k-step kk in a[4 kk .. 4 kk + 3]), b an N-major kTile x DP tile at `base`.
template <int DP>
__device__ __forceinline__ void rs_product(float (&acc)[DP / 2],
                                           const uint32_t (&a)[16],
                                           uint32_t base) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if constexpr (DP == 64)
      wgmma_rs_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                   a[4 * kk + 3], nmajor(base, kk));
    else
      wgmma_rs_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                    a[4 * kk + 3], nmajor(base, kk));
  }
}

// s[64 x 64] = a b^T over the head dim: a the `block`-th 64 rows of a
// stationary kRows x DP tile, b a streamed kTile x DP tile (both K-major).
template <int DP>
__device__ __forceinline__ void ss_product(float (&s)[32], uint32_t a,
                                           int block, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(s, kmajor<kRows>(a, block, kk), kmajor<kTile>(b, 0, kk),
                 kk > 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x without the branches of exp2f; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Some pair of rows [q0, q0 + 64) and keys [k0, k0 + 64) is visible.
__device__ __forceinline__ bool any_visible(const Params& p, int q0, int k0) {
  if (q0 >= p.S || k0 >= p.S) return false;
  const int q_last = min(q0 + kTile, p.S) - 1;
  const int k_last = min(k0 + kTile, p.S) - 1;
  if (p.causal && k0 > q_last) return false;
  if (p.window > 0 && (long long)k_last + p.window - 1 < q0) return false;
  return true;
}

// Every pair of rows [q0, q0 + 64) and keys [k0, k0 + 64) is visible.
__device__ __forceinline__ bool all_visible(const Params& p, int q0, int k0) {
  if (q0 + kTile > p.S || k0 + kTile > p.S) return false;
  if (p.causal && k0 + kTile - 1 > q0) return false;
  if (p.window > 0 && (long long)q0 + kTile - 1 - k0 >= p.window)
    return false;
  return true;
}

// The forward's mask as intervals: the q rows [lo, hi] that see key
// `kpos`, and the keys [lo, hi] that row `qpos` sees (empty past S).
__device__ __forceinline__ int2 rows_of_key(const Params& p, int kpos) {
  if (kpos >= p.S) return make_int2(1, 0);
  long long hi = p.S - 1;
  if (p.window > 0) hi = min(hi, (long long)kpos + p.window - 1);
  return make_int2(p.causal ? kpos : 0, (int)hi);
}
__device__ __forceinline__ int2 keys_of_row(const Params& p, int qpos) {
  if (qpos >= p.S) return make_int2(1, 0);
  long long lo = 0;
  if (p.window > 0) lo = max(lo, (long long)qpos - p.window + 1);
  return make_int2((int)lo, p.causal ? qpos : p.S - 1);
}

// ---- 1. prep: delta and lse * log2(e), padded ------------------------------

// DP / 8 lanes a row, 8 columns (16 bytes) each.
template <int DP>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, Strides so, Strides sdo,
                float* __restrict__ lse2, float* __restrict__ delta, int B,
                int H, int S, int S_pad, int d) {
  constexpr int kLanes = DP / 8, kPerWarp = 32 / kLanes;
  const int lane = threadIdx.x % 32;
  const long long row =
      ((long long)blockIdx.x * 8 + threadIdx.x / 32) * kPerWarp +
      lane / kLanes;
  const long long n = (long long)B * H * S_pad;
  const int s = (int)(row % S_pad);
  const long long bh = row / S_pad;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const int c = (lane % kLanes) * 8;
  float acc = 0.0f;
  if (row < n && s < S && c < d) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + (long long)s * so.s + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * sdo.b + h * sdo.h + (long long)s * sdo.s + c);
    const bf16* op = reinterpret_cast<const bf16*>(&ov);
    const bf16* gp = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc = fmaf(__bfloat162float(op[i]), __bfloat162float(gp[i]), acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < n && lane % kLanes == 0) {
    delta[row] = s < S ? acc : 0.0f;
    lse2[row] = s < S ? lse[bh * S + s] * kLog2e : 0.0f;
  }
}

// ---- 2. dK, dV --------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const Params p) {
  using L = Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* stat_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = stat_full + 1;
  uint64_t* empty = full + kStages;
  float* ring_vec = reinterpret_cast<float*>(smem + L::kVec) + 2 * kRows;

  const int n_bk = p.B * p.K;
  const int k0 = (int)(blockIdx.x / n_bk) * kRows;  // the first kv tiles
  const int b = (int)(blockIdx.x % n_bk) / p.K;     // (most work) first
  const int kvh = (int)(blockIdx.x % n_bk) % p.K;
  const int group = p.H / p.K;
  // q tiles that see a key of this block: q >= k0 (causal) and
  // q <= k_last + window - 1 (window)
  const int q_lo = p.causal ? k0 / kTile : 0;
  int q_hi = (p.S - 1) / kTile;
  if (p.window > 0) {
    const long long last = (long long)min(k0 + kRows, p.S) - 1 + p.window - 1;
    if (last / kTile < q_hi) q_hi = (int)(last / kTile);
  }

  if (threadIdx.x == 0) {
    mbar_init(stat_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {
    // ---- producer: one thread loads K and V, then keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(stat_full, 2 * L::kStatTile);
      load_tile<DP, kRows>(smem, &kmap, stat_full, k0, kvh, b);
      load_tile<DP, kRows>(smem + L::kStatTile, &vmap, stat_full, k0, kvh, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int h = kvh * group + hh;
        const long long vrow = ((long long)b * p.H + h) * p.S_pad;
        for (int qt = q_lo; qt <= q_hi; ++qt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + L::kRing + stage * 2 * L::kRingTile;
          float* sv = ring_vec + stage * 2 * kTile;
          mbar_expect_tx(&full[stage], 2 * L::kRingTile + 2 * kTile * 4);
          load_tile<DP, kTile>(st, &qmap, &full[stage], qt * kTile, h, b);
          load_tile<DP, kTile>(st + L::kRingTile, &domap, &full[stage],
                               qt * kTile, h, b);
          bulk_load(sv, p.lse2 + vrow + qt * kTile, kTile * 4, &full[stage]);
          bulk_load(sv + kTile, p.delta + vrow + qt * kTile, kTile * 4,
                    &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int kw0 = k0 + wgi * kTile;
    const uint32_t kbase = smem_u32(smem);
    const uint32_t vbase = kbase + L::kStatTile;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
    // the q rows that see this thread's two keys, 16 warp + g and 8 more
    const int2 band[2] = {rows_of_key(p, kw0 + 16 * warp + g),
                          rows_of_key(p, kw0 + 16 * warp + g + 8)};
    mbar_wait(stat_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int hh = 0; hh < group; ++hh) {
      for (int qt = q_lo; qt <= q_hi; ++qt) {
        const int q0 = qt * kTile;
        mbar_wait(&full[stage], phase);
        if (any_visible(p, q0, kw0)) {
          const uint32_t qs =
              smem_u32(smem + L::kRing + stage * 2 * L::kRingTile);
          const uint32_t dos = qs + L::kRingTile;
          const float* sv = ring_vec + stage * 2 * kTile;
          // S^T = K Q^T, dP^T = V dO^T: rows are keys, columns q rows
          float s[32], dp[32];
          fence_regs(s);
          fence_regs(dp);
          wgmma_fence();
          ss_product<DP>(s, kbase, wgi, qs);
          wgmma_commit();
          ss_product<DP>(dp, vbase, wgi, dos);
          wgmma_commit();
          wgmma_wait<1>();  // S^T is done; dP^T may still run
          fence_regs(s);
          // P^T: lse2 per column (q row); element 4 c + e at key
          // 16 warp + g + 8 (e / 2), q row 8 c + 2 qd + e % 2.  The mask
          // only on tiles the band's edge cuts.
          if (all_visible(p, q0, kw0)) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float2 l2 =
                  *reinterpret_cast<const float2*>(sv + 8 * c + 2 * qd);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * c + e] = exp2_ftz(fmaf(s[4 * c + e], p.scale_log2,
                                             -((e & 1) ? l2.y : l2.x)));
            }
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const int col = 8 * c + 2 * qd;
              const float2 l2 = *reinterpret_cast<const float2*>(sv + col);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = 4 * c + e;
                const int qpos = q0 + col + (e & 1);
                const int2 lim = band[e >> 1];
                const float pr = exp2_ftz(
                    fmaf(s[i], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
                s[i] = qpos >= lim.x && qpos <= lim.y ? pr : 0.0f;
              }
            }
          }
          wgmma_wait<0>();
          fence_regs(dp);
          // dS^T = P^T (dP^T - delta), delta per column
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float2 dl = *reinterpret_cast<const float2*>(
                sv + kTile + 8 * c + 2 * qd);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * c + e] = s[4 * c + e] *
                              (dp[4 * c + e] - ((e & 1) ? dl.y : dl.x));
          }
          // dV += P^T dO, dK += dS^T Q: P^T and dS^T as bf16 register A
          // operands (the accumulator's layout is the A layout), dO and Q
          // N-major
          uint32_t pa[16], dsa[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
            dsa[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
          }
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(dsa);
          wgmma_fence();
          rs_product<DP>(dv, pa, dos);
          rs_product<DP>(dk, dsa, qs);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(dsa);
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    // epilogue: bf16 pairs straight to dk and dv, rows past S and columns
    // past d skipped
    bf16* dkg = p.dk + b * p.sdk.b + kvh * p.sdk.h;
    bf16* dvg = p.dv + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * qd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = kw0 + 16 * warp + g + 8 * half;
        if (row < p.S && col < p.d) {
          const int i = 4 * c + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(dkg + (long long)row * p.sdk.s +
                                             col) =
              __floats2bfloat162_rn(dk[i] * p.scale, dk[i + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvg + (long long)row * p.sdv.s +
                                             col) =
              __floats2bfloat162_rn(dv[i], dv[i + 1]);
        }
      }
    }
  }
}

// ---- 3. dQ ------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const Params p) {
  using L = Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* stat_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = stat_full + 1;
  uint64_t* empty = full + kStages;
  float* stat_vec = reinterpret_cast<float*>(smem + L::kVec);

  const int n_bh = p.B * p.H;
  const int n_qt = (p.S + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / n_bh)) * kRows;  // the last
  const int bh = (int)(blockIdx.x % n_bh);                     // q tiles first
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.K);
  // the kv tiles [lo, hi] of 64 keys that meet rows [q0, q0 + kRows), as
  // the forward's tile_range
  const int q_end = min(q0 + kRows, p.S) - 1;
  const int hi = p.causal ? q_end / kTile : (p.S - 1) / kTile;
  int lo = 0;
  if (p.window > 0) {
    const long long num = (long long)q0 - p.window - kTile + 2;
    if (num > 0) lo = (int)((num + kTile - 1) / kTile);
  }

  if (threadIdx.x == 0) {
    mbar_init(stat_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {
    // ---- producer: Q, dO, lse2 and delta once, then the K and V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      const long long vrow = (long long)bh * p.S_pad + q0;
      mbar_expect_tx(stat_full, 2 * L::kStatTile + 2 * kRows * 4);
      load_tile<DP, kRows>(smem, &qmap, stat_full, q0, h, b);
      load_tile<DP, kRows>(smem + L::kStatTile, &domap, stat_full, q0, h, b);
      bulk_load(stat_vec, p.lse2 + vrow, kRows * 4, stat_full);
      bulk_load(stat_vec + kRows, p.delta + vrow, kRows * 4, stat_full);
      int stage = 0;
      uint32_t phase = 0;
      for (int jt = lo; jt <= hi; ++jt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + L::kRing + stage * 2 * L::kRingTile;
        mbar_expect_tx(&full[stage], 2 * L::kRingTile);
        load_tile<DP, kTile>(st, &kmap, &full[stage], jt * kTile, kvh, b);
        load_tile<DP, kTile>(st + L::kRingTile, &vmap, &full[stage],
                             jt * kTile, kvh, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int qw0 = q0 + wgi * kTile;
    const uint32_t qbase = smem_u32(smem);
    const uint32_t dobase = qbase + L::kStatTile;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
    mbar_wait(stat_full, 0);
    // this thread's two rows, 16 warp + g and 8 more
    const int r0 = wgi * kTile + 16 * warp + g;
    const float l2[2] = {stat_vec[r0], stat_vec[r0 + 8]};
    const float dl[2] = {stat_vec[kRows + r0], stat_vec[kRows + r0 + 8]};
    // the keys these two rows see
    const int2 band[2] = {keys_of_row(p, qw0 + 16 * warp + g),
                          keys_of_row(p, qw0 + 16 * warp + g + 8)};
    int stage = 0;
    uint32_t phase = 0;
    for (int jt = lo; jt <= hi; ++jt) {
      const int k0 = jt * kTile;
      mbar_wait(&full[stage], phase);
      if (any_visible(p, qw0, k0)) {
        const uint32_t ks =
            smem_u32(smem + L::kRing + stage * 2 * L::kRingTile);
        const uint32_t vs = ks + L::kRingTile;
        // S = Q K^T, dP = dO V^T: rows are q rows, columns keys
        float s[32], dp[32];
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        ss_product<DP>(s, qbase, wgi, ks);
        wgmma_commit();
        ss_product<DP>(dp, dobase, wgi, vs);
        wgmma_commit();
        wgmma_wait<1>();  // S is done; dP may still run
        fence_regs(s);
        // P: lse2 per row; element i at row 16 warp + g + 8 ((i / 2) % 2),
        // key 8 (i / 4) + 2 qd + i % 2.  The mask only on edge tiles.
        if (all_visible(p, qw0, k0)) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = exp2_ftz(fmaf(s[i], p.scale_log2, -l2[(i >> 1) & 1]));
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int kpos = k0 + 8 * (i >> 2) + 2 * qd + (i & 1);
            const int2 lim = band[(i >> 1) & 1];
            const float pr =
                exp2_ftz(fmaf(s[i], p.scale_log2, -l2[(i >> 1) & 1]));
            s[i] = kpos >= lim.x && kpos <= lim.y ? pr : 0.0f;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
        // dQ += dS K: dS the register A operand, K N-major
        uint32_t dsa[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dsa[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
        fence_regs(dq);
        fence_regs(dsa);
        wgmma_fence();
        rs_product<DP>(dq, dsa, ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dsa);
      }
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    bf16* dqg = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * qd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = qw0 + 16 * warp + g + 8 * half;
        if (row < p.S && col < p.d) {
          const int i = 4 * c + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(dqg + (long long)row * p.sdq.s +
                                             col) =
              __floats2bfloat162_rn(dq[i] * p.scale, dq[i + 1] * p.scale);
        }
      }
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A 4-D map over bf16 [B, heads, S, D] memory with the given (batch, head,
// sequence) strides in elements: box [1, 1, 64 rows, 64 columns], 128-byte
// swizzle, out-of-range elements read as zero.  A dimension of extent 1
// gets the stride of dense memory, so that no stride of a dimension it
// never steps through is refused.
bool encode_4d(CUtensorMap* map, const void* base, int D, int S, int heads,
               int B, const Strides& st) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t s1 = S > 1 ? (cuuint64_t)st.s * 2 : (cuuint64_t)D * 2;
  const cuuint64_t s2 = heads > 1 ? (cuuint64_t)st.h * 2 : s1 * S;
  const cuuint64_t s3 = B > 1 ? (cuuint64_t)st.b * 2 : s2 * heads;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {s1, s2, s3};
  cuuint32_t box[4] = {64, kTile, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int DP>
cudaError_t run(const Maps& m, const Params& p, const bf16* o,
                const bf16* dout, const float* lse, Strides so, Strides sdo,
                cudaStream_t stream) {
  constexpr int kPerBlock = 8 * (32 / (DP / 8));  // rows of a prep block
  const long long rows = (long long)p.B * p.H * p.S_pad;
  const long long n_prep = (rows + kPerBlock - 1) / kPerBlock;
  const long long n_tiles = (p.S + kRows - 1) / kRows;
  const long long n_dkdv = n_tiles * p.B * p.K;
  const long long n_dq = n_tiles * p.B * p.H;
  if (n_prep > 0x7fffffffLL || n_dkdv > 0x7fffffffLL || n_dq > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  bwd_prep_kernel<DP><<<(unsigned)n_prep, 256, 0, stream>>>(
      o, dout, lse, so, sdo, const_cast<float*>(p.lse2),
      const_cast<float*>(p.delta), p.B, p.H, p.S, p.S_pad, p.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = Smem<DP>::kBytes;
  err = cudaFuncSetAttribute(bwd_dkdv_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_wgmma_kernel<DP><<<(unsigned)n_dkdv, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma_kernel<DP><<<(unsigned)n_dq, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Every stride of a dimension wider than 1 a nonzero multiple of 8
// elements (16 bytes).
bool rows_aligned(const Strides& st, int B, int heads, int S) {
  auto ok = [](long long s, int n) { return n == 1 || (s != 0 && s % 8 == 0); };
  return ok(st.b, B) && ok(st.h, heads) && ok(st.s, S);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* scratch, void* dq, void* dk, void* dv,
                   const Strides* st, int B, int H, int K, int S, int D,
                   int causal, int window, float scale, cudaStream_t stream) {
  // st: q, k, v, o, dout, dq, dk, dv
  if (D % 8 != 0 || D > 128) return cudaErrorInvalidValue;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (int i = 0; i < 8; ++i) {
    const int heads = (i == 1 || i == 2 || i == 6 || i == 7) ? K : H;
    if (!aligned16(ptrs[i]) || !rows_aligned(st[i], B, heads, S))
      return cudaErrorInvalidValue;  // the wrapper's rule sends these to simt
  }
  Params p;
  p.S_pad = (S + kRows - 1) / kRows * kRows;
  p.lse2 = scratch;
  p.delta = scratch + (long long)B * H * p.S_pad;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.sdq = st[5];
  p.sdk = st[6];
  p.sdv = st[7];
  p.B = B;
  p.H = H;
  p.K = K;
  p.S = S;
  p.d = D;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  Maps m;
  if (!encode_4d(&m.q, q, D, S, H, B, st[0]) ||
      !encode_4d(&m.k, k, D, S, K, B, st[1]) ||
      !encode_4d(&m.v, v, D, S, K, B, st[2]) ||
      !encode_4d(&m.dout, dout, D, S, H, B, st[4]))
    return cudaErrorInvalidValue;
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* gb = static_cast<const bf16*>(dout);
  if (D <= 64) return run<64>(m, p, ob, gb, lse, st[3], st[4], stream);
  return run<128>(m, p, ob, gb, lse, st[3], st[4], stream);
}

}  // namespace wg

}  // namespace

// dq, dk, dv of attention(q, k, v) for q, o, dout, dq [B, H, S, D] and k, v,
// dk, dv [B, K, S, D], each given by its base and its (batch, head,
// sequence) strides in elements (`strides`: q's three, then k's, v's, o's,
// dout's, dq's, dk's, dv's); lse [B, H, S] f32 from the forward.  causal:
// 0 or 1; window <= 0: none.  dtype: 0 = float32, 1 = bfloat16.
// 1 <= D <= 128.  variant: 0 = simt, whose f32 `scratch` holds [B, H, S];
// 1 = wgmma (bf16, D a multiple of 8, every base 16-byte aligned and every
// stride of a dimension wider than 1 a nonzero multiple of 8), whose
// `scratch` holds 2 * B * H * S_pad, S_pad = S rounded up to 128.  Returns
// the first failed launch's cudaError_t, or 0; a variant that cannot take
// the inputs returns cudaErrorInvalidValue without launching.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* scratch, void* dq, void* dk,
                                   void* dv, const long long* strides, int B,
                                   int H, int K, int S, int D, int causal,
                                   int window, float scale, int dtype,
                                   int variant, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = strides_at(strides + 3 * i);
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)wg::launch(q, k, v, o, dout, lse, scratch, dq, dk, dv, st, B,
                           H, K, S, D, causal, window, scale, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = scratch;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = st[0];
  p.sk = st[1];
  p.sv = st[2];
  p.so = st[3];
  p.sdo = st[4];
  p.sdq = st[5];
  p.sdk = st[6];
  p.sdv = st[7];
  p.B = B;
  p.H = H;
  p.K = K;
  p.S = S;
  p.d = D;
  p.n_qt = (S + kBQ - 1) / kBQ;
  p.n_kt = (S + kBK - 1) / kBK;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  if (dtype == 0) return (int)run_width<float>(p, s);
  if (dtype == 1) return (int)run_width<bf16>(p, s);
  return (int)cudaErrorInvalidValue;
}
