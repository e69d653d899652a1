// Blockwise (flash) attention forward with GQA, causal masking and a sliding
// window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`, body `_flash_kernel`):
//   o[b, h] = softmax(q[b, h] k[b, h / g]^T * scale + mask) v[b, h / g]
// for q [B, H, S, D], k and v [B, K, S, D], g = H / K (GQA through the kv
// head index, no repeat), scale = 1 / sqrt(D), the mask the finite -1e30
// outside the causal band and the window, and the output
// acc / max(l, 1e-30) in q's dtype.
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
// order, so one block owns one (batch * head, 64-row q tile) and loops over
// the kv tiles itself, from the first to the last tile that meets the band
// (`tile_range`): tiles outside it are never loaded.  Per row the running
// max, sum and correction live in shared memory.
//   bf16: 4 warps, 16 q rows each.  Scores and P @ V run on the tensor cores
//   (WMMA 16x16x16 bf16 fragments, f32 accumulation); the scores go through
//   shared memory for the online softmax.  The TPU kernel multiplies f32
//   probabilities by v, so P enters the second product as two bf16 terms,
//   hi = bf16(p) and lo = bf16(p - hi), 16 bits of p: with P rounded to
//   bf16 alone, 4 outputs in 10 land a bf16 step away from the reference's.
//   The f32 accumulator lives in shared memory so that each row can be
//   rescaled between tiles.
//   f32: 256 threads of plain f32 FMAs (no TF32), 4x4 scores and
//   4 x (D / 16) outputs a thread, the accumulator in registers.
// Masked scores are the reference's finite -1e30, not -inf: a row whose
// first tiles are all masked accumulates weights of exp(0) that the first
// visible score wipes (the correction exp(-1e30 - m) is 0), and every valid
// row meets its own diagonal (causal) or the keys at or after itself
// (window), so no row ends on garbage.  kv tiles go in ascending order.
// Any S >= 1: rows and keys past S are zero-filled and masked.  Any head dim
// up to 128 runs in the instance of the next width of 16, 32, 64 or 128, its
// extra columns zero-filled.  No TMA, wgmma or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;   // q rows of a block
constexpr int kBK = 64;   // keys of a kv tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, K, S, d;  // d: the real head dim (<= the instance's DP)
  int n_qt;        // q tiles per (batch, head)
  int causal;
  int window;      // <= 0: no window
  float scale;
  int vec;         // rows may be copied in 16-byte vectors
};

// The kv tiles [lo, hi] that meet the band of q rows [q0, q0 + kBQ) ∩ [0, S):
// a tile is needed iff k_start <= q_end (causal) and
// k_end > q_start - window (window), as the TPU kernel's in_band test.
__device__ __forceinline__ void tile_range(const Params& p, int q0, int* lo,
                                           int* hi) {
  const int q_end = min(q0 + kBQ, p.S) - 1;
  *hi = p.causal ? q_end / kBK : (p.S - 1) / kBK;
  *lo = 0;
  if (p.window > 0) {
    // (lo + 1) * kBK - 1 > q0 - window  <=>  lo * kBK >= q0 - window - kBK + 2
    const int num = q0 - p.window - kBK + 2;
    if (num > 0) *lo = (num + kBK - 1) / kBK;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  if (kpos >= p.S) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// Rows [row0, row0 + 64) of a [S, d] matrix into a [64][LD] shared tile of
// DP columns, zero past S and past d.
template <typename T, int DP, int LD>
__device__ void load_tile(T* s, const T* g, int row0, const Params& p) {
  constexpr int kVec = 16 / sizeof(T);
  if (p.vec && LD % kVec == 0) {  // d == DP, 16-byte aligned rows
    constexpr int kChunks = DP / kVec;
    for (int c = threadIdx.x; c < kBQ * kChunks; c += blockDim.x) {
      const int r = c / kChunks, col = (c % kChunks) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < p.S)
        val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * DP +
                                              col);
      *reinterpret_cast<uint4*>(s + r * LD + col) = val;
    }
    return;
  }
  for (int c = threadIdx.x; c < kBQ * DP; c += blockDim.x) {
    const int r = c / DP, col = c % DP;
    T val = T(0.0f);
    if (row0 + r < p.S && col < p.d) val = g[(long long)(row0 + r) * p.d + col];
    s[r * LD + col] = val;
  }
}

// ---- bf16: WMMA on tensor cores ------------------------------------------

constexpr int kThreadsBf16 = 128;

template <int DP>
constexpr size_t bf16_smem_bytes() {
  return (size_t)3 * kBQ * (DP + 8) * sizeof(bf16)  // q, k, v tiles
         + (size_t)kBQ * (kBK + 4) * sizeof(float)   // scores, then lo
         + (size_t)kBQ * (kBK + 8) * sizeof(bf16)    // probabilities, hi
         + (size_t)kBQ * (DP + 4) * sizeof(float)    // accumulator
         + (size_t)3 * kBQ * sizeof(float);          // max, sum, correction
}

template <int DP>
__global__ void __launch_bounds__(kThreadsBf16)
flash_bf16_kernel(Params p) {
  using namespace nvcuda;
  constexpr int LDQ = DP + 8;   // bf16 tiles: 16-byte aligned rows
  constexpr int LDS = kBK + 4;  // f32 scores
  constexpr int LDL = 2 * LDS;  // the lo terms, bf16, over the scores
  constexpr int LDP = kBK + 8;  // bf16 probabilities (hi terms)
  constexpr int LDO = DP + 4;   // f32 accumulator
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * LDQ;
  bf16* Vs = Ks + kBK * LDQ;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * LDQ);
  bf16* Ls = reinterpret_cast<bf16*>(Ss);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kBQ * LDS);
  float* Os = reinterpret_cast<float*>(Ps + kBQ * LDP);
  float* row_m = Os + kBQ * LDO;
  float* row_l = row_m + kBQ;
  float* row_c = row_l + kBQ;

  const int bh = blockIdx.x / p.n_qt;
  const int q0 = (blockIdx.x % p.n_qt) * kBQ;
  const int b = bh / p.H, h = bh % p.H;
  const long long kvh = (long long)b * p.K + h / (p.H / p.K);
  const long long head = (long long)p.S * p.d;
  const bf16* qg = static_cast<const bf16*>(p.q) + (long long)bh * head;
  const bf16* kg = static_cast<const bf16*>(p.k) + kvh * head;
  const bf16* vg = static_cast<const bf16*>(p.v) + kvh * head;
  bf16* og = static_cast<bf16*>(p.o) + (long long)bh * head;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's 16 rows of the q tile

  load_tile<bf16, DP, LDQ>(Qs, qg, q0, p);
  for (int t = threadIdx.x; t < kBQ * LDO; t += kThreadsBf16) Os[t] = 0.0f;
  if (threadIdx.x < kBQ) {
    row_m[threadIdx.x] = kNegInf;
    row_l[threadIdx.x] = 0.0f;
  }

  int lo, hi;
  tile_range(p, q0, &lo, &hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's k and v are no longer read
    load_tile<bf16, DP, LDQ>(Ks, kg, k0, p);
    load_tile<bf16, DP, LDQ>(Vs, vg, k0, p);
    __syncthreads();

    // Scores of this warp's rows: [16, 64] = Q_w K^T.
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + r0 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(bt, Ks + n * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * LDS + n * 16, acc, LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax: two lanes a row, 32 keys each, held in registers.
    {
      const int r = r0 + lane / 2, c0 = (lane % 2) * 32;
      const int qpos = q0 + r;
      float e[32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = c0 + j;
        e[j] = visible(p, qpos, k0 + c) ? Ss[r * LDS + c] * p.scale : kNegInf;
        mx = fmaxf(mx, e[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float pr = expf(e[j] - m_new);
        const bf16 ph = __float2bfloat16(pr);
        Ps[r * LDP + c0 + j] = ph;
        e[j] = pr - __bfloat162float(ph);
        sum += pr;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_prev - m_new);
      __syncwarp();  // the warp has read its scores and both lanes row_m[r]
#pragma unroll
      for (int j = 0; j < 32; ++j)
        Ls[r * LDL + c0 + j] = __float2bfloat16(e[j]);
      if (lane % 2 == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * corr + sum;
        row_c[r] = corr;
      }
    }
    __syncwarp();

    // Rescale this warp's accumulator rows, then add P_w V.
    for (int t = lane; t < 16 * DP; t += 32) {
      const int r = r0 + t / DP;
      Os[r * LDO + t % DP] *= row_c[r];
    }
    __syncwarp();
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r0 * LDO + n * 16, LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p_hi;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> p_lo;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(p_hi, Ps + r0 * LDP + kk, LDP);
        wmma::load_matrix_sync(p_lo, Ls + r0 * LDL + kk, LDL);
        wmma::load_matrix_sync(bv, Vs + kk * LDQ + n * 16, LDQ);
        wmma::mma_sync(acc, p_lo, bv, acc);
        wmma::mma_sync(acc, p_hi, bv, acc);
      }
      wmma::store_matrix_sync(Os + r0 * LDO + n * 16, acc, LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int t = lane; t < 16 * DP; t += 32) {
    const int r = r0 + t / DP, c = t % DP;
    const int qpos = q0 + r;
    if (qpos < p.S && c < p.d)
      og[(long long)qpos * p.d + c] =
          __float2bfloat16(Os[r * LDO + c] / fmaxf(row_l[r], 1e-30f));
  }
}

// ---- f32: SIMT FMAs, no TF32 ---------------------------------------------

constexpr int kThreadsF32 = 256;

template <int DP>
constexpr size_t f32_smem_bytes() {
  return (size_t)kBQ * DP * sizeof(float)           // q tile
         + (size_t)kBK * (DP + 1) * sizeof(float)   // k tile, padded rows
         + (size_t)kBK * DP * sizeof(float)         // v tile
         + (size_t)kBQ * (kBK + 1) * sizeof(float)  // scores, probabilities
         + (size_t)3 * kBQ * sizeof(float);         // max, sum, correction
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_f32_kernel(Params p) {
  constexpr int LDK = DP + 1;   // conflict-free reads down a key column
  constexpr int LDS = kBK + 1;
  constexpr int kCols = DP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * DP;
  float* Vs = Ks + kBK * LDK;
  float* Ss = Vs + kBK * DP;
  float* row_m = Ss + kBQ * LDS;
  float* row_l = row_m + kBQ;
  float* row_c = row_l + kBQ;

  const int bh = blockIdx.x / p.n_qt;
  const int q0 = (blockIdx.x % p.n_qt) * kBQ;
  const int b = bh / p.H, h = bh % p.H;
  const long long kvh = (long long)b * p.K + h / (p.H / p.K);
  const long long head = (long long)p.S * p.d;
  const float* qg = static_cast<const float*>(p.q) + (long long)bh * head;
  const float* kg = static_cast<const float*>(p.k) + kvh * head;
  const float* vg = static_cast<const float*>(p.v) + kvh * head;
  float* og = static_cast<float*>(p.o) + (long long)bh * head;
  // rows ty * 4 + i; score columns and output columns tx + 16 * j
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<float, DP, DP>(Qs, qg, q0, p);
  if (threadIdx.x < kBQ) {
    row_m[threadIdx.x] = kNegInf;
    row_l[threadIdx.x] = 0.0f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  int lo, hi;
  tile_range(p, q0, &lo, &hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the last tile's k, v and probabilities are read
    load_tile<float, DP, LDK>(Ks, kg, k0, p);
    load_tile<float, DP, DP>(Vs, vg, k0, p);
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
      if (qpos < p.S && c < p.d) og[(long long)qpos * p.d + c] = acc[i][j] / l;
    }
  }
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

}  // namespace

// o = attention(q, k, v) for q, o [B, H, S, D] and k, v [B, K, S, D],
// contiguous.  causal: 0 or 1; window <= 0: none.  dtype: 0 = float32,
// 1 = bfloat16.  1 <= D <= 128.  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int K, int S, int D,
                               int causal, int window, float scale, int dtype,
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
  p.H = H;
  p.K = K;
  p.S = S;
  p.d = D;
  p.n_qt = (S + kBQ - 1) / kBQ;
  p.causal = causal != 0;
  p.window = window;
  p.scale = scale;
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  p.vec = aligned && D == dp;  // whole 16-byte rows
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
