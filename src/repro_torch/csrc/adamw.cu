// AdamW over a whole tree of parameters in two launches: the gradients'
// per-leaf sums of squares (sq_norm), then one fused update (adamw_step).
//
// Replaces no TPU kernel: the reference's AdamW (src/repro/optim/adamw.py,
// `adamw_update`) is plain jnp that XLA fuses.  The port's plain version
// (kernels/adamw/ref.py) updates one leaf at a time in about 16 PyTorch
// passes with a temporary each, about 152 bytes of device memory a f32
// parameter.  The same arithmetic needs 32: the update reads p, g, m and v
// once and writes p, m and v once (28 B a f32 parameter), and the norm reads
// every gradient once (4 B).  Both kernels are bound by those bytes over the
// HBM rate (3.35 TB/s on an H100 SXM): nothing here is worth a tensor core.
// Two passes are the least: the clip scale min(1, clip / max(norm, 1e-9))
// needs the whole tree's norm before any leaf may be updated.
//
// The leaf table.  Every leaf is cut into blocks of kBlockElems elements (a
// fixed partition: the wrapper's `plan` numbers them, the last block of a
// leaf holding its tail), and one launch covers up to kCapacity leaves, whose
// pointers, sizes and first blocks travel in the kernel's arguments (a
// __grid_constant__ struct, read in place from the constant bank: no copy
// from the host, which from pageable memory would sync the stream).  A grid
// of a few CTAs per SM walks the blocks (grid-stride); a CTA finds its
// block's leaf by a binary search of the first blocks (two CTAs of 256
// threads an SM: on an H100 the update ran 3 to 4% faster so than with one,
// three or four, or with two vectors a thread in flight).  Threads take 8
// elements at a time, with 128-bit loads and stores (two for f32 data, one
// for bf16), and the leaf's tail of under 8 elements scalar.  The wrapper
// checks that every tensor is contiguous and 16-byte aligned.
//
// sq_norm.  Each block's sum of squares (f32) goes to `partials[block]`:
// every thread sums its elements in a fixed order, then the CTA adds the
// threads' sums in a fixed tree.  The last CTA to finish (an integer ticket,
// set to zero by the entry point before the launch) adds each leaf's partials
// in block order, again in a fixed tree, and writes the leaf's sum to
// out[index].  No float atomics: the same gradients give the same bits on
// every call, whatever the grid.
//
// adamw_step.  Per element, in f32 with IEEE rounding at every operation
// (the _rn intrinsics: no contraction into FMAs, no fast math), the plain
// version's terms in its order:
//   scale = min(1, (1 / max(norm, 1e-9)) * clip)   (1 without a clip; read
//            from the norm on the device: no sync)
//   g32 = g * scale
//   m = b1 m + (1 - b1) g32
//   v = b2 v + (1 - b2) g32^2
//   p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)
// The moments are f32; a bf16 parameter is updated in f32 and rounded once
// to nearest even.  Instances: (parameter, gradient) in {f32, bf16}^2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                     // elements a thread takes at once
constexpr long long kBlockElems = 1 << 15;  // kernels/adamw/adamw.py BLOCK_ELEMS
constexpr int kCapacity = 64;               // kernels/adamw/adamw.py CAPACITY
constexpr int kCtasPerSm = 2;  // 3 to 4% faster than 1, 3 or 4
constexpr int kMaxDevices = 64;

struct UpdateTable {
  int n;
  void* p[kCapacity];
  const void* g[kCapacity];
  float* m[kCapacity];
  float* v[kCapacity];
  long long size[kCapacity];
  long long first[kCapacity + 1];  // first[n]: the launch's blocks
};

struct NormTable {
  int n;
  int out[kCapacity];
  const void* g[kCapacity];
  long long size[kCapacity];
  long long first[kCapacity + 1];
};

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, clip;
};

// the leaf holding block b: the largest i with first[i] <= b (an empty leaf
// shares its first block with the next and is never found)
template <typename T>
__device__ __forceinline__ int find_leaf(const T& t, long long b) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void load8(const float* s, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(s)[0];
  const float4 b = reinterpret_cast<const float4*>(s)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* s,
                                      float (&x)[kVec]) {
  const uint4 a = *reinterpret_cast<const uint4*>(s);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* d, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(d)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* d,
                                       const float (&x)[kVec]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  }
  *reinterpret_cast<uint4*>(d) = a;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* d, float x) { *d = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* d, float x) {
  *d = __float2bfloat16_rn(x);
}

// the sum of x over the CTA, in a fixed order, on every thread; smem holds
// kWarps floats and may be reused right after
__device__ __forceinline__ float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // every thread has read the previous sum
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  x = lane < kWarps ? smem[lane] : 0.f;
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
sq_norm_kernel(const __grid_constant__ NormTable t, float* partials,
               unsigned int* ticket, float* out) {
  __shared__ float smem[kWarps];
  __shared__ bool last;
  const long long blocks = t.first[t.n];
  for (long long b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int i = find_leaf(t, b);
    const G* g = static_cast<const G*>(t.g[i]);
    const long long start = (b - t.first[i]) * kBlockElems;
    const long long rest = t.size[i] - start;
    const long long end = start + (rest < kBlockElems ? rest : kBlockElems);
    const long long vec_end = start + (end - start) / kVec * kVec;
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
    for (long long e = start + (long long)threadIdx.x * kVec; e < vec_end;
         e += (long long)kThreads * kVec) {
      float x[kVec];
      load8(g + e, x);
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[k] = __fmaf_rn(x[k], x[k], acc[k]);
    }
    const long long e = vec_end + threadIdx.x;
    if (e < end) {
      const float x = to_f32(g[e]);
      acc[0] = __fmaf_rn(x, x, acc[0]);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) s += acc[k];
    s = block_sum(s, smem);
    if (threadIdx.x == 0) partials[b] = s;
  }
  // the last CTA to finish adds each leaf's partials in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = 0; i < t.n; ++i) {
    float acc = 0.f;
    for (long long b = t.first[i] + threadIdx.x; b < t.first[i + 1];
         b += kThreads) {
      acc += __ldcg(partials + b);
    }
    acc = block_sum(acc, smem);
    if (threadIdx.x == 0) out[t.out[i]] = acc;
  }
}

__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, const Hyper& h,
                                           float scale) {
  const float g32 = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(g32, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(g32, g32), h.omb2));
  float step = __fdiv_rn(__fdiv_rn(m, h.bc1),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  step = __fadd_rn(step, __fmul_rn(p, h.wd));
  p = __fsub_rn(p, __fmul_rn(step, h.lr));
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ UpdateTable t, const Hyper h,
             const float* norm) {
  float scale = 1.f;
  if (norm != nullptr) {
    // torch.clamp's order and NaN: a NaN norm gives a NaN scale
    const float n = *norm;
    const float c = n < 1e-9f ? 1e-9f : n;
    const float s = __fmul_rn(__frcp_rn(c), h.clip);
    scale = s > 1.f ? 1.f : s;
  }
  const long long blocks = t.first[t.n];
  for (long long b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int i = find_leaf(t, b);
    P* p = static_cast<P*>(t.p[i]);
    const G* g = static_cast<const G*>(t.g[i]);
    float* m = t.m[i];
    float* v = t.v[i];
    const long long start = (b - t.first[i]) * kBlockElems;
    const long long rest = t.size[i] - start;
    const long long end = start + (rest < kBlockElems ? rest : kBlockElems);
    const long long vec_end = start + (end - start) / kVec * kVec;
    for (long long e = start + (long long)threadIdx.x * kVec; e < vec_end;
         e += (long long)kThreads * kVec) {
      float pp[kVec], gg[kVec], mm[kVec], vv[kVec];
      load8(p + e, pp);
      load8(g + e, gg);
      load8(m + e, mm);
      load8(v + e, vv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        adamw_elem(pp[k], gg[k], mm[k], vv[k], h, scale);
      }
      store8(p + e, pp);
      store8(m + e, mm);
      store8(v + e, vv);
    }
    const long long e = vec_end + threadIdx.x;
    if (e < end) {
      float pe = to_f32(p[e]), me = m[e], ve = v[e];
      adamw_elem(pe, to_f32(g[e]), me, ve, h, scale);
      from_f32(p + e, pe);
      m[e] = me;
      v[e] = ve;
    }
  }
}

// CTAs of a grid-stride launch over `blocks` blocks on the current device
cudaError_t grid_size(long long blocks, int* grid) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  const long long most = (long long)sms[dev] * kCtasPerSm;
  *grid = (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
  return cudaSuccess;
}

// the table's first blocks: 0, non-decreasing, first[i + 1] - first[i] the
// blocks of size[i]
bool table_ok(int n, const long long* size, const long long* first) {
  if (n < 1 || n > kCapacity || first[0] != 0) return false;
  for (int i = 0; i < n; ++i) {
    if (size[i] < 0 ||
        first[i + 1] - first[i] != (size[i] + kBlockElems - 1) / kBlockElems)
      return false;
  }
  return true;
}

template <typename P, typename G>
cudaError_t launch_step(const UpdateTable& t, const Hyper& h,
                        const float* norm, int grid, cudaStream_t stream) {
  adamw_kernel<P, G><<<grid, kThreads, 0, stream>>>(t, h, norm);
  return cudaGetLastError();
}

template <typename G>
cudaError_t launch_norm(const NormTable& t, float* partials,
                        unsigned int* ticket, float* out, int grid,
                        cudaStream_t stream) {
  sq_norm_kernel<G><<<grid, kThreads, 0, stream>>>(t, partials, ticket, out);
  return cudaGetLastError();
}

}  // namespace

// One fused AdamW update of `n` leaves (at most kCapacity): leaf i's
// parameter p[i] (dtype p_dtype: 0 f32, 1 bf16), gradient g[i] (g_dtype) and
// f32 moments m[i], v[i], each of size[i] elements, contiguous and 16-byte
// aligned; first[0..n] the leaves' first blocks of `block_elems` elements,
// which must be the kernel's.  omb1 and omb2: 1 - b1 and 1 - b2, rounded to
// f32 from the caller's (the plain version's) wider values.  `norm`: the
// gradients' global norm (an f32 on
// the device) for the clip at `clip`, or null for none.  Returns the launch's
// cudaError_t (0 on success); a table the kernel cannot take returns
// cudaErrorInvalidValue without launching.
extern "C" int adamw_step(int n, const long long* p, const long long* g,
                          const long long* m, const long long* v,
                          const long long* size, const long long* first,
                          long long block_elems, int p_dtype, int g_dtype,
                          float lr, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, float bc1,
                          float bc2, const float* norm, float clip,
                          void* stream) {
  if (block_elems != kBlockElems || !table_ok(n, size, first) ||
      p_dtype < 0 || p_dtype > 1 || g_dtype < 0 || g_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (first[n] == 0) return 0;
  UpdateTable t;
  t.n = n;
  for (int i = 0; i < n; ++i) {
    t.p[i] = reinterpret_cast<void*>(p[i]);
    t.g[i] = reinterpret_cast<const void*>(g[i]);
    t.m[i] = reinterpret_cast<float*>(m[i]);
    t.v[i] = reinterpret_cast<float*>(v[i]);
    t.size[i] = size[i];
    t.first[i] = first[i];
  }
  t.first[n] = first[n];
  const Hyper h = {lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2, clip};
  int grid = 0;
  cudaError_t err = grid_size(first[n], &grid);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && g_dtype == 0)
    return (int)launch_step<float, float>(t, h, norm, grid, s);
  if (p_dtype == 0)
    return (int)launch_step<float, __nv_bfloat16>(t, h, norm, grid, s);
  if (g_dtype == 0)
    return (int)launch_step<__nv_bfloat16, float>(t, h, norm, grid, s);
  return (int)launch_step<__nv_bfloat16, __nv_bfloat16>(t, h, norm, grid, s);
}

// The f32 sum of squares of each of `n` gradients (at most kCapacity; dtype
// 0 f32, 1 bf16; contiguous, 16-byte aligned) into out[index[i]].
// `partials` holds first[n] floats and `ticket` one unsigned int, both on
// the device; the ticket is set to zero here, on the stream, before the
// launch.
extern "C" int sq_norm(int n, const long long* g, const long long* size,
                       const long long* first, const int* index,
                       long long block_elems, int dtype, float* partials,
                       unsigned int* ticket, float* out, void* stream) {
  if (block_elems != kBlockElems || !table_ok(n, size, first) || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  NormTable t;
  t.n = n;
  for (int i = 0; i < n; ++i) {
    t.out[i] = index[i];
    t.g[i] = reinterpret_cast<const void*>(g[i]);
    t.size[i] = size[i];
    t.first[i] = first[i];
  }
  t.first[n] = first[n];
  int grid = 0;
  cudaError_t err = grid_size(first[n], &grid);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) return (int)launch_norm<float>(t, partials, ticket, out,
                                                 grid, s);
  return (int)launch_norm<__nv_bfloat16>(t, partials, ticket, out, grid, s);
}
