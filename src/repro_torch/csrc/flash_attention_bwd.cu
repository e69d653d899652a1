// Backward of the blockwise (flash) attention with GQA, causal masking and a
// sliding window.
//
// The Pallas TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// is forward only; the reference trains through the gradient of its einsum
// attention (src/repro/models/layers.py).  The port's forward runs on
// flash_attention.cu, so its gradient is this kernel, FA2's recompute:
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
// dq, dk, dv once at 3.35 TB/s.  At the training shapes it is bound by the
// operations.
//
// Design: simple and right first, deterministic, no atomics.  Three kernels
// on the stream:
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
// Each block is 256 threads of plain f32 FMAs (no TF32, no tensor cores),
// inputs converted to f32 in shared memory: a thread computes a 4 x 4 patch
// of S and dP (q rows ty * 4 + i, keys tx + 16 * j) and 4 rows of D / 16
// columns of its accumulators.  The scores are recomputed in both passes.
// Using mma.sync or wgmma, and one pass with dQ summed across blocks, is
// the later redesign's work (ROADMAP Queue 2).
// Any S >= 1 and any head dim up to 128, in the instance of the next width
// of 16, 32, 64 or 128, extra columns zero-filled.  f32 and bf16 inputs;
// every sum is f32, the results are stored in the inputs' dtype.

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

}  // namespace

// dq, dk, dv of attention(q, k, v) for q, o, dout, dq [B, H, S, D] and k, v,
// dk, dv [B, K, S, D], each given by its base and its (batch, head,
// sequence) strides in elements (`strides`: q's three, then k's, v's, o's,
// dout's, dq's, dk's, dv's); lse [B, H, S] f32 from the forward; delta
// [B, H, S] f32 scratch.  causal: 0 or 1; window <= 0: none.  dtype:
// 0 = float32, 1 = bfloat16.  1 <= D <= 128.  Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   const long long* strides, int B, int H,
                                   int K, int S, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = strides_at(strides);
  p.sk = strides_at(strides + 3);
  p.sv = strides_at(strides + 6);
  p.so = strides_at(strides + 9);
  p.sdo = strides_at(strides + 12);
  p.sdq = strides_at(strides + 15);
  p.sdk = strides_at(strides + 18);
  p.sdv = strides_at(strides + 21);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_width<float>(p, s);
  if (dtype == 1) return (int)run_width<bf16>(p, s);
  return (int)cudaErrorInvalidValue;
}
