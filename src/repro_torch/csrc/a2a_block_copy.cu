// Block gather / scatter for the plan-driven All-to-All (a2a_pack, a2a_unpack).
//
// Replaces the Pallas TPU kernel pair in src/repro/kernels/a2a_pack/a2a_pack.py
// (`a2a_pack` and `a2a_unpack`, both built by `_block_call` around
// `_copy_kernel`).  There the index vector rides in scalar-prefetch memory and
// drives one DMA per (8, 128)-tiled block.
//
//   pack   (scatter == 0): dst block i      <- src block idx[i]
//   unpack (scatter == 1): dst block idx[i] <- src block i
//
// Bound on the card: pure data movement, so bytes read plus bytes written over
// the HBM rate (3.35 TB/s on an H100 SXM).  The kernel knows no element type:
// f32, bf16 and int8 blocks are all bytes.  An index outside [0, n_bound)
// would read or write outside the tensors: the kernel checks it and traps,
// which fails the launch's stream.  Unpack writes no block that idx does not
// name.
//
// Three instances, picked by the wrapper's rule (a2a_pack.variant), never as
// a fallback:
//
// bulk (block_bytes % 16 == 0, src and dst 16-byte aligned, at least 512 MiB
//   moved): Hopper's counterpart of the TPU's one DMA per block, the bulk
//   asynchronous copy (cp.async.bulk, TMA's one-dimensional form).  The work
//   is (block, chunk) items, a chunk being kChunk bytes or the whole block
//   when it is smaller.  A persistent grid of at most one CTA per SM (the SM
//   count read once per device and cached) walks them, each CTA a
//   contiguous run of items.  One thread per CTA keeps a ring of up to
//   kMaxStages chunks of shared memory (kRingBytes in all): it loads a chunk
//   with cp.async.bulk.shared::cluster.global, completing on the stage's
//   mbarrier (expect_tx of the chunk's bytes), waits for it, stores it with
//   cp.async.bulk.global.shared::cta into a bulk group, and refills the
//   stage of the previous item once cp.async.bulk.wait_group.read has seen
//   that store read it.  Before the CTA exits, cp.async.bulk.wait_group 0
//   waits for every store.  What this does about the first kernel's costs:
//   - its grid of (M, tiles) CTAs of 256 threads ran in waves (2048 CTAs at
//     megatron's decode exchange, 1.9 waves) and started and stopped CTAs by
//     the thousand at prefill; the persistent grid launches once per SM;
//   - each of its CTAs loaded its index, then its data, a dependent global
//     load before the first byte; here the next block's index is read ahead
//     while earlier copies are in flight, and unpack, whose source is not
//     indexed, starts its load before it checks the index;
//   - registers and occupancy bounded its bytes in flight; here the shared
//     ring does (up to S loads per SM), and the copy engine computes the
//     addresses.  The issuing thread's loop runs no division.
//   A wait on an mbarrier that lasts about 10 s traps instead of hanging the
//   card.  Timed on an H100 beside vec (PERF.md): below 32 MiB moved, where
//   the data sits in the 50 MB L2, it is 20 to 30% slower; from 32 to 256
//   MiB within 3% either way, vec mostly ahead; from 512 MiB (mixtral's
//   prefill exchanges) up to 2% ahead.  So the rule gives it those alone.
// vec (aligned as bulk, under 512 MiB): the first kernel's 16-byte path, a
//   grid of (M, tiles) CTAs of 256 threads, four uint4 loads a thread.
// bytes (any other block): the same grid, one byte a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- bytes and vec: the first kernel, a CTA per (block, tile) -----------

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
cudaError_t launch_tiles(const void* src, void* dst, const int* idx,
                         long long m, long long n_bound, long long block_elems,
                         int scatter, cudaStream_t stream) {
  if (m > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long tile = (long long)kThreads * kUnroll;
  long long tiles = (block_elems + tile - 1) / tile;
  if (tiles > 65535) tiles = 65535;
  dim3 grid((unsigned)m, (unsigned)tiles);
  block_copy_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(src), static_cast<V*>(dst), idx, n_bound,
      block_elems, scatter);
  return cudaGetLastError();
}

// ---- bulk: cp.async.bulk through a shared-memory ring ---------------------

constexpr long long kChunk = 32 << 10;  // 16 and 64 KB were no faster
constexpr int kRingBytes = 192 << 10;
constexpr int kMaxStages = 16;
// kMaxStages mbarriers, destination offsets and byte counts
constexpr int kHeader = kMaxStages * (8 + 8 + 4);
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
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

__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(gmem)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          reinterpret_cast<uint64_t>(gmem)),
      "r"(smem_u32(smem)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(32, 1)
bulk_copy_kernel(const unsigned char* __restrict__ src,
                 unsigned char* __restrict__ dst, const int* __restrict__ idx,
                 long long n_bound, long long block_bytes, long long chunk,
                 long long chunks, long long items, int stages, int scatter) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  long long* dst_off = reinterpret_cast<long long*>(smem + kMaxStages * 8);
  uint32_t* nbytes = reinterpret_cast<uint32_t*>(smem + kMaxStages * 16);
  unsigned char* ring = smem + kHeader;
  if (threadIdx.x != 0) return;

  // this CTA's contiguous run of n items from q0; item q is chunk
  // q % chunks of block q / chunks.  Every cursor below advances by
  // additions: the one thread runs no division in its loop.
  const long long per = items / gridDim.x, extra = items % gridDim.x;
  const long long b = blockIdx.x;
  const long long q0 = b * per + (b < extra ? b : extra);
  const long long n = per + (b < extra ? 1 : 0);
  long long m = q0 / chunks;            // the load cursor's block
  long long off = (q0 - m * chunks) * chunk;  // and its byte offset in it
  long long j = __ldg(idx + m);         // its index, read ahead of its use

  for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  long long issued = 0;
  int load_stage = 0;
  auto issue = [&]() {
    const long long rest = block_bytes - off;
    const uint32_t bytes = (uint32_t)(rest < chunk ? rest : chunk);
    const bool bad = j < 0 || j >= n_bound;
    if (!scatter && bad) __trap();  // pack reads block j
    mbar_expect_tx(&full[load_stage], bytes);
    bulk_load(ring + (long long)load_stage * chunk,
              src + (scatter ? m : j) * block_bytes + off, bytes,
              &full[load_stage]);
    if (scatter && bad) __trap();   // unpack writes block j
    dst_off[load_stage] = (scatter ? j : m) * block_bytes + off;
    nbytes[load_stage] = bytes;
    load_stage = load_stage + 1 == stages ? 0 : load_stage + 1;
    off += chunk;
    if (++issued < n && off >= block_bytes) {  // next block: read its index
      off = 0;
      j = __ldg(idx + ++m);
    }
  };

  while (issued < n && issued < stages) issue();
  int stage = 0;
  uint32_t phase = 0;
  for (long long k = 0; k < n; ++k) {
    mbar_wait(&full[stage], phase);
    bulk_store(dst + dst_off[stage], ring + (long long)stage * chunk,
               nbytes[stage]);
    if (k >= 1 && issued < n) {
      // the stage of item k - 1 is free once its store has read it
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue();
    }
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

cudaError_t launch_bulk(const void* src, void* dst, const int* idx,
                        long long m, long long n_bound, long long block_bytes,
                        int scatter, cudaStream_t stream) {
  // per device, set once: the SM count and the kernel's shared-memory limit
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bulk_copy_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kHeader + kRingBytes);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  const long long chunk = block_bytes < kChunk ? block_bytes : kChunk;
  const long long chunks = (block_bytes + chunk - 1) / chunk;
  const long long items = m * chunks;
  long long stages = kRingBytes / chunk;
  if (stages > kMaxStages) stages = kMaxStages;
  const int grid = (int)(items < sms[dev] ? items : sms[dev]);
  const int smem = kHeader + (int)(stages * chunk);
  bulk_copy_kernel<<<grid, 32, smem, stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      idx, n_bound, block_bytes, chunk, chunks, items, (int)stages, scatter);
  return cudaGetLastError();
}

}  // namespace

// Copy `m` blocks of `block_bytes` bytes.
//   scatter == 0 (pack):   dst block i      <- src block idx[i]
//   scatter == 1 (unpack): dst block idx[i] <- src block i
// `n_bound` is the number of blocks on the indexed side.  variant: 0 = bytes,
// 1 = bulk, 2 = vec (both need block_bytes a multiple of 16 and 16-byte
// aligned src and dst).  Returns the launch's cudaError_t (0 on success); a variant that
// cannot take the call returns cudaErrorInvalidValue without launching.
extern "C" int a2a_block_copy(const void* src, void* dst, const int* idx,
                              long long m, long long n_bound,
                              long long block_bytes, int scatter, int variant,
                              void* stream) {
  if (m <= 0 || block_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      block_bytes % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) %
              16 == 0;
  if (variant == 0) {
    return (int)launch_tiles<unsigned char>(src, dst, idx, m, n_bound,
                                            block_bytes, scatter, s);
  }
  if (!aligned) return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    return (int)launch_bulk(src, dst, idx, m, n_bound, block_bytes, scatter, s);
  }
  if (variant == 2) {
    return (int)launch_tiles<uint4>(src, dst, idx, m, n_bound,
                                    block_bytes / 16, scatter, s);
  }
  return (int)cudaErrorInvalidValue;
}
