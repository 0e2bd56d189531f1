// Block-cyclic repack for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `blockcyclic_repack` / `_repack_kernel`
// (src/repro/kernels/blockcyclic.py): the block gather out[i] = src[idx[i]]
// that is the local hot loop of DMRlib's block-cyclic redistribution.  On
// the TPU the index vector rode in scalar-prefetch SMEM and drove the input
// BlockSpec; here each CTA reads the indices of its own units.
//
// What bounds it on the card: bytes only (no arithmetic) -- every byte of
// the output is read once from src and written once, 2 x 394 MB at the
// block-cyclic path's shape, ~0.24 ms at 3.35 TB/s.  Reaching that takes
// many bytes in flight per SM: a thread that loads 16 bytes and then
// stores them (the first version of this kernel) keeps too few, and
// reached 0.85 of the bound.
//
// Two device paths, by alignment (the wrapper checks it):
// * bulk (block_bytes % 16 == 0 and src, out 16-byte aligned).  A
//   persistent grid, two CTAs per SM, walks the units (output block, 32 KB
//   slice) of the gather.  Each CTA is one thread's worth of issue: it
//   fills a ring of kStages shared-memory stages with 1-D bulk copies (TMA,
//   cp.async.bulk ... mbarrier::complete_tx::bytes, no tensor map), and
//   drains each stage, as soon as its mbarrier says it landed, with a bulk
//   store (cp.async.bulk.global.shared::cta.bulk_group).  A stage is
//   refilled once its store has read it, so kStages - 1 loads and one or
//   two stores of 32 KB are in flight per CTA: ~200 KB per SM.
// * bytes (anything else): one CTA per (output block, 64 KB slice), a byte
//   per thread and step.
//
// The wrapper validates every index on the host before it uploads them
// (pinned memory, asynchronously: no stream synchronisation): an
// out-of-range index would read outside src.
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

// ---- bulk path -------------------------------------------------------------

constexpr int kStages = 3;
constexpr int kStageBytes = 32 * 1024;
constexpr int kBulkCtasPerSm = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// bytes from global memory into shared memory; completion is counted on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// bytes from shared memory to global memory, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// every bulk group but the newest N has finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One thread per CTA issues everything; unit u is slice u % spb of output
// block u / spb, and this CTA takes units blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(32)
repack_bulk_kernel(const char* __restrict__ src, char* __restrict__ out,
                   const int* __restrict__ idx, long long nout,
                   long long block_bytes, long long spb) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  const long long units = nout * spb, first = blockIdx.x, step = gridDim.x;
  const long long n = first < units ? (units - first + step - 1) / step : 0;
  for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // the k-th unit of this CTA: its output offset, source and size
  auto unit = [&](long long k, long long& to, const char*& from,
                  uint32_t& bytes) {
    const long long u = first + k * step, i = u / spb;
    const long long off = (u % spb) * kStageBytes;
    bytes = static_cast<uint32_t>(min(static_cast<long long>(kStageBytes),
                                      block_bytes - off));
    to = i * block_bytes + off;
    from = src + static_cast<long long>(idx[i]) * block_bytes + off;
  };
  auto issue = [&](long long k) {
    long long to;
    const char* from;
    uint32_t bytes;
    unit(k, to, from, bytes);
    const int s = static_cast<int>(k % kStages);
    mbar_expect_tx(&full[s], bytes);
    bulk_load(ring + s * kStageBytes, from, bytes, &full[s]);
  };

  for (long long k = 0; k < n && k < kStages; ++k) issue(k);
  for (long long k = 0; k < n; ++k) {
    const int s = static_cast<int>(k % kStages);
    mbar_wait(&full[s], static_cast<uint32_t>((k / kStages) & 1));
    long long to;
    const char* from;
    uint32_t bytes;
    unit(k, to, from, bytes);
    bulk_store(out + to, ring + s * kStageBytes, bytes);
    // refill the stage of unit k - 1 once its store has read it
    if (k >= 1 && k - 1 + kStages < n) {
      bulk_wait_read<1>();
      issue(k - 1 + kStages);
    }
  }
  bulk_wait_all();
}

// ---- bytes path --------------------------------------------------------------

constexpr int kThreads = 256;
constexpr long long kSliceBytes = 64 * 1024;

__global__ void __launch_bounds__(kThreads)
repack_bytes_kernel(const unsigned char* __restrict__ src,
                    unsigned char* __restrict__ out,
                    const int* __restrict__ idx, long long block_bytes) {
  const long long i = blockIdx.x;
  const long long s0 = blockIdx.y * kSliceBytes;
  const long long s1 = min(block_bytes, s0 + kSliceBytes);
  const unsigned char* from = src + static_cast<long long>(idx[i]) * block_bytes;
  unsigned char* to = out + i * block_bytes;
  for (long long e = s0 + threadIdx.x; e < s1; e += kThreads) to[e] = from[e];
}

cudaError_t launch_bulk(const void* src, void* out, const int* idx,
                        long long nout, long long block_bytes,
                        cudaStream_t stream) {
  const long long spb = (block_bytes + kStageBytes - 1) / kStageBytes;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(repack_bulk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStages * kStageBytes);
  if (err != cudaSuccess) return err;
  const long long units = nout * spb;
  const long long ctas =
      std::min(units, static_cast<long long>(kBulkCtasPerSm) * sms);
  repack_bulk_kernel<<<static_cast<unsigned>(ctas), 32,
                       kStages * kStageBytes, stream>>>(
      static_cast<const char*>(src), static_cast<char*>(out), idx, nout,
      block_bytes, spb);
  return cudaGetLastError();
}

cudaError_t launch_bytes(const void* src, void* out, const int* idx,
                         long long nout, long long block_bytes,
                         cudaStream_t stream) {
  const long long nslices = (block_bytes + kSliceBytes - 1) / kSliceBytes;
  if (nout > 0x7fffffffLL || nslices > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nout), static_cast<unsigned>(nslices));
  repack_bytes_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(out),
      idx, block_bytes);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Copies nout blocks of block_bytes each.  bulk != 0 selects the bulk path,
// which needs block_bytes % 16 == 0 and src, out 16-byte aligned (else the
// call is refused).  Returns a cudaError_t (0 = launched).
extern "C" int blockcyclic_repack(const void* src, void* out, const int* idx,
                                  long long nout, long long block_bytes,
                                  int bulk, void* stream) {
  if (nout < 0 || block_bytes < 0 ||
      (bulk && (block_bytes % 16 != 0 || !aligned16(src) || !aligned16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nout == 0 || block_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bulk ? launch_bulk(src, out, idx, nout, block_bytes, s)
                         : launch_bytes(src, out, idx, nout, block_bytes, s);
  return static_cast<int>(err);
}
