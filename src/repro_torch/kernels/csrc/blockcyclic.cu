// Block-cyclic repack for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `blockcyclic_repack` / `_repack_kernel`
// (src/repro/kernels/blockcyclic.py): the block gather out[i] = src[idx[i]]
// that is the local hot loop of DMRlib's block-cyclic redistribution.  On
// the TPU the index vector rode in scalar-prefetch SMEM and drove the input
// BlockSpec; here each CTA reads its own index.
//
// What bounds it on the card: bytes only (no arithmetic) — every byte of
// the output is read once from src and written once.  So each CTA copies a
// slice of one output block with 16-byte loads and stores per thread when
// the block size and both base pointers allow it (the wrapper checks), and
// byte by byte otherwise; the grid is (output block, slice of kSliceBytes)
// so a few large blocks still spread over every SM.  The wrapper validates
// every index on the host before upload: an out-of-range index would read
// outside src.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kSliceBytes = 64 * 1024;

template <typename U>
__global__ void __launch_bounds__(kThreads)
repack_kernel(const U* __restrict__ src, U* __restrict__ out,
              const int* __restrict__ idx, long long block_elems,
              long long slice_elems) {
  const long long i = blockIdx.x;
  const long long s0 = blockIdx.y * slice_elems;
  const long long s1 = min(block_elems, s0 + slice_elems);
  const U* from = src + static_cast<long long>(idx[i]) * block_elems;
  U* to = out + i * block_elems;
  for (long long e = s0 + threadIdx.x; e < s1; e += kThreads) to[e] = from[e];
}

template <typename U>
cudaError_t launch(const void* src, void* out, const int* idx, long long nout,
                   long long block_bytes, cudaStream_t stream) {
  const long long block_elems = block_bytes / static_cast<long long>(sizeof(U));
  const long long slice_elems = kSliceBytes / static_cast<long long>(sizeof(U));
  const long long nslices = (block_elems + slice_elems - 1) / slice_elems;
  if (nout > 0x7fffffffLL || nslices > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nout), static_cast<unsigned>(nslices));
  repack_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(src), static_cast<U*>(out), idx, block_elems,
      slice_elems);
  return cudaGetLastError();
}

}  // namespace

// Copies nout blocks of block_bytes each.  vec16 != 0 selects 16-byte
// copies (block_bytes % 16 == 0 and src/out 16-byte aligned).  Returns a
// cudaError_t (0 = launched).
extern "C" int blockcyclic_repack(const void* src, void* out, const int* idx,
                                  long long nout, long long block_bytes,
                                  int vec16, void* stream) {
  if (nout == 0 || block_bytes == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = vec16
      ? launch<uint4>(src, out, idx, nout, block_bytes, s)
      : launch<unsigned char>(src, out, idx, nout, block_bytes, s);
  return static_cast<int>(err);
}
