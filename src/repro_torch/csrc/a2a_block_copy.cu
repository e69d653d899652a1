// Block gather / scatter for the plan-driven All-to-All (a2a_pack, a2a_unpack).
//
// Replaces the Pallas TPU kernel pair in src/repro/kernels/a2a_pack/a2a_pack.py
// (`a2a_pack` and `a2a_unpack`, both built by `_block_call` around
// `_copy_kernel`).  There the index vector rides in scalar-prefetch memory and
// drives one DMA per (8, 128)-tiled block.  Here each CUDA block loads its own
// index and copies one contiguous tile of a `block_bytes`-byte block.
//
// Bound on the card: pure data movement, so bytes read plus bytes written over
// the HBM rate (3.35 TB/s on an H100 SXM).  The design keeps every load and
// store 16 bytes wide and contiguous across a warp whenever the block size and
// both base pointers allow it, and falls back to single bytes otherwise.  It
// knows nothing of the element type, so f32, bf16 and int8 share one kernel.
//
// Grid: x = index m (one destination or source block each), y = tile within
// the block (grid-strided, so any block size fits in the 65535 limit).
//
// An index outside [0, n_bound) would read or write outside the tensors: the
// kernel checks the bound and traps, which fails the launch's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename V>
__global__ void __launch_bounds__(kThreads)
block_copy_kernel(const V* __restrict__ src, V* __restrict__ dst,
                  const int* __restrict__ idx, long long n_bound,
                  long long block_elems, int scatter) {
  const long long m = blockIdx.x;
  const long long j = idx[m];
  if (j < 0 || j >= n_bound) {
    __trap();
  }
  const V* s = src + (scatter ? m : j) * block_elems;
  V* d = dst + (scatter ? j : m) * block_elems;
  const long long tile = (long long)kThreads * kUnroll;
  for (long long base = (long long)blockIdx.y * tile; base < block_elems;
       base += (long long)gridDim.y * tile) {
    V r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads + threadIdx.x;
      if (e < block_elems) r[u] = s[e];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + (long long)u * kThreads + threadIdx.x;
      if (e < block_elems) d[e] = r[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* src, void* dst, const int* idx, long long m,
                   long long n_bound, long long block_elems, int scatter,
                   cudaStream_t stream) {
  const long long tile = (long long)kThreads * kUnroll;
  long long tiles = (block_elems + tile - 1) / tile;
  if (tiles > 65535) tiles = 65535;
  dim3 grid((unsigned)m, (unsigned)tiles);
  block_copy_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), idx, n_bound,
      block_elems, scatter);
  return cudaGetLastError();
}

}  // namespace

// Copy `m` blocks of `block_bytes` bytes.
//   scatter == 0 (pack):   dst block i      <- src block idx[i]
//   scatter == 1 (unpack): dst block idx[i] <- src block i
// `n_bound` is the number of blocks on the indexed side.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int a2a_block_copy(const void* src, void* dst, const int* idx,
                              long long m, long long n_bound,
                              long long block_bytes, int scatter,
                              void* stream) {
  if (m <= 0 || block_bytes <= 0) return 0;
  if (m > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (vec) {
    return (int)launch<uint4>(src, dst, idx, m, n_bound, block_bytes / 16,
                              scatter, s);
  }
  return (int)launch<unsigned char>(src, dst, idx, m, n_bound, block_bytes,
                                    scatter, s);
}
