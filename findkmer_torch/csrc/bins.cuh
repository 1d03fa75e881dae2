// The binning shared by the histogram kernels K1 (histogram.cu) and K2
// (window_histogram.cu): exact int32 counts of window codes over 4^k bins
// (k <= 10), with integer atomics.
//
//   * shared (k <= 6, 4^k * 4 B <= 16 KiB): every block keeps a private
//     histogram in static shared memory (`bins_zero`), counts its windows
//     there with shared atomicAdd, then adds its non-zero bins to the
//     global table (`bins_flush`).
//   * global (k = 7..10, whose 64 KiB .. 4 MiB of bins exceed a block's
//     static shared memory): atomicAdd straight into the global table,
//     which stays resident in the 50 MB L2.
//
// Both kernels walk their work with a grid stride over at most
// kBlocksPerSm blocks per SM (`grid_blocks`), so a shared-memory launch
// flushes a bounded number of private histograms.  Integer atomics
// commute: the counts are bit-exact whatever order the blocks run in.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxK = 10;
constexpr int kSharedMaxK = 6;
constexpr int kSharedBins = 1 << (2 * kSharedMaxK);  // 4096 bins, 16 KiB

// Zero a block's private bins; every thread of the block must call it.
__device__ __forceinline__ void bins_zero(int32_t* bins, uint32_t nbins) {
  for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
}

// Add a block's non-zero private bins into the global table; every thread
// of the block must call it, after its last count.
__device__ __forceinline__ void bins_flush(const int32_t* bins, uint32_t nbins,
                                           int32_t* out) {
  __syncthreads();
  for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) {
    const int32_t v = bins[b];
    if (v) atomicAdd(&out[b], v);
  }
}

// Blocks for `items` grid-stride work items of one thread each: enough to
// cover them, at most kBlocksPerSm per SM of the current device.
inline cudaError_t grid_blocks(int64_t items, int* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t need = (items + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  *blocks = (int)(need < cap ? need : cap);
  return cudaSuccess;
}

}  // namespace
