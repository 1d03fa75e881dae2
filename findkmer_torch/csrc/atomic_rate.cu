// A yardstick, not a kernel of any path: the rate at which the card does
// integer atomic adds to random addresses, in a block's shared memory and
// in the global table behind the L2.  chip_smoke.py times it at the table
// sizes of the histogram kernels (histogram.cu, window_histogram.cu), so
// that their times can be read against one atomic a window as well as
// against their bytes.
//
// Every thread does `per_thread` adds of 1 to pseudo-random words
// (xorshift32, seeded by its index) of a table of `words` 32-bit words
// (a power of two).  With `shared` each block has the table in dynamic
// shared memory and one block runs a time on an SM above 113 KiB; without,
// all blocks share `table`.  `half` adds to a random 16-bit half of the
// word (1 or 65,536), as bins.cuh's HalfBins does.  The adds return
// nothing.  Launches blocks_per_sm blocks an SM of 256 threads (512 with
// `shared` above 48 KiB); the caller computes the adds done from that.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <bool kShared>
__global__ void __launch_bounds__(512)
atomic_rate(uint32_t* __restrict__ table, uint32_t words, int per_thread,
            int half) {
  extern __shared__ uint32_t smem[];
  uint32_t* t = kShared ? smem : table;
  if (kShared) {
    for (uint32_t w = threadIdx.x; w < words; w += blockDim.x) smem[w] = 0;
    __syncthreads();
  }
  uint32_t x = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 1u;
  for (int i = 0; i < per_thread; ++i) {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
    const uint32_t addend = half ? 1u << ((x >> 27) & 16u) : 1u;
    atomicAdd(t + ((x >> 4) & (words - 1u)), addend);
  }
  if (kShared) {  // keep the table's sums alive
    __syncthreads();
    uint32_t sum = 0;
    for (uint32_t w = threadIdx.x; w < words; w += blockDim.x) sum += smem[w];
    if (sum == 0xffffffffu) table[0] = sum;
  }
}

}  // namespace

// -> a CUDA error code; *threads_out = threads launched in all.
extern "C" int fk_atomic_rate(void* table, int64_t words, int shared,
                              int half, int blocks_per_sm, int per_thread,
                              int64_t* threads_out, void* stream) {
  if (words < 1 || (words & (words - 1)) || blocks_per_sm < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = shared ? (size_t)words * 4 : 0;
  const int threads = bytes > 48 * 1024 ? 512 : 256;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(atomic_rate<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = sms * blocks_per_sm;
  *threads_out = (int64_t)blocks * threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    atomic_rate<true><<<blocks, threads, bytes, s>>>(
        (uint32_t*)table, (uint32_t)words, per_thread, half);
  } else {
    atomic_rate<false><<<blocks, threads, 0, s>>>(
        (uint32_t*)table, (uint32_t)words, per_thread, half);
  }
  return (int)cudaGetLastError();
}
