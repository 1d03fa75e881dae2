// The binning shared by the histogram kernels K1 (histogram.cu) and K2
// (window_histogram.cu): exact int32 counts of window codes over 4^k bins
// (k <= 10), with integer atomics only.
//
// What bounds a histogram on an H100 is where its atomics land.  An atomic
// on the global table is served by the L2 (tens of G atomics a second for
// the whole card, measured by atomic_rate.cu); an atomic on a block's own
// shared memory is served by its SM, and 132 SMs do that side by side.  So
// a block keeps private bins in dynamic shared memory wherever the table,
// or a part of it, fits an SM's 227 KB, and adds them to the global table
// once, at its end (`flush`).  Three layouts, one interface
// (`add(code, n)`, `flush()`):
//
//   * WordBins (k <= 7): 4^k int32 bins, 1 KiB .. 64 KiB a block of 512
//     threads (three blocks an SM at k = 7).
//   * HalfBins (k = 8, 9): 65,536 bins of 16 bits, two a word, 128 KiB a
//     block (one block of 1024 threads an SM).  int32 bins for k = 8 would
//     take 256 KiB, more than a block may hold; halves of the table in two
//     blocks would extract every window twice, and each further extraction
//     of a (1024, 65536) batch costs an H100 about 0.11 ms (k = 9's four
//     parts took 0.51 ms where k = 8's one took 0.17), so two halves would
//     take about 0.28 ms.  A half that passes 65,535 is not lost:
//     `atomicAdd` returns the word as it was, so the one add that makes
//     the low half wrap sees it (old low half + n > 65,535), and the one
//     add that makes the whole word wrap (which is the high half wrapping,
//     by its own adds or by a carry out of the low half) sees that
//     (old + addend < old).  Each such add moves the 65,536 that left the
//     shared word to the global table at once, and takes back from the
//     high half's global bin the 1 that a low wrap carried into it.  Every
//     step is an integer add to one shared word or one global bin, so the
//     sums are exact in any order of the threads (the global bin of a high
//     half may stand one below its final value until the flush).
//     k = 9 has four times the bins: the table is cut by the top two bits
//     of the code into four parts, a block owns one part, extracts every
//     window of its share of the input and bins only the codes of its
//     part.  The input is read four times, but from the L2, and four
//     extractions are cheaper than an L2 atomic a window (0.51 against
//     0.81 ms on an H100).  At k = 10 sixteen parts would not be.
//   * GlobalBins (k = 10, and any k >= 7 when the batch is small):
//     atomicAdd straight into the global table, which stays resident in
//     the 50 MB L2.  Private bins cost a block the zeroing and the flush
//     of its table (up to 128 KiB) whatever it counted, and they pay only
//     when each block counts many times more windows than it has bins; a
//     record of a few thousand bases must not pay for them.  The wrappers
//     choose (findkmer_torch/ops/cuda/histogram_kernel.py::private_bins:
//     private for k <= 6 always, for k = 7..9 from 64 windows a bin).
//
// A launch with private bins is one wave of persistent blocks: as many as
// fit the card at once (by the occupancy the runtime reports for the
// kernel's shared memory), each walking its share of the input with a grid
// stride, so a batch flushes a few hundred tables however large it is.
// The flush adds only non-zero bins.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // a block of GlobalBins
constexpr int kWordThreads = 512;   // a block of WordBins: 3 an SM at k = 7
constexpr int kHalfThreads = 1024;  // the one block an SM of HalfBins
constexpr int kMaxK = 10;
constexpr int kWordMaxK = 7;    // int32 bins in shared memory up to here
constexpr int kSharedMaxK = 9;  // private bins of either layout up to here
constexpr int kHalfBinsLog2 = 16;  // bins of one HalfBins table

struct GlobalBins {
  static constexpr int kBlock = kThreads;
  int32_t* out;

  __device__ GlobalBins(int32_t* out_, uint32_t*, int, uint32_t) : out(out_) {}
  __device__ __forceinline__ void add(uint32_t code, int32_t n) const {
    atomicAdd(out + code, n);
  }
  __device__ __forceinline__ void flush() const {}
};

struct WordBins {
  static constexpr int kBlock = kWordThreads;
  int32_t* out;
  int32_t* bins;
  uint32_t nbins;

  // Every thread of the block constructs it (zeroing, then a barrier).
  __device__ WordBins(int32_t* out_, uint32_t* smem, int k, uint32_t)
      : out(out_), bins((int32_t*)smem), nbins(1u << (2 * k)) {
    for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) bins[b] = 0;
    __syncthreads();
  }
  __device__ __forceinline__ void add(uint32_t code, int32_t n) const {
    atomicAdd(bins + code, n);
  }
  // Every thread of the block calls it, after its last add.
  __device__ __forceinline__ void flush() const {
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) {
      const int32_t v = bins[b];
      if (v) atomicAdd(out + b, v);
    }
  }
};

struct HalfBins {
  static constexpr int kBlock = kHalfThreads;
  static constexpr uint32_t kBins = 1u << kHalfBinsLog2;
  int32_t* out;    // the global bins of this block's part
  uint32_t* bins;  // kBins / 2 words: bin b is half b & 1 of word b >> 1
  uint32_t part;   // the top bits of the codes this block counts

  __device__ HalfBins(int32_t* out_, uint32_t* smem, int, uint32_t part_)
      : out(out_ + (size_t)part_ * kBins), bins(smem), part(part_) {
    for (uint32_t w = threadIdx.x; w < kBins / 2; w += blockDim.x) bins[w] = 0;
    __syncthreads();
  }
  // 0 < n < 65,536.
  __device__ __forceinline__ void add(uint32_t code, int32_t n) const {
    if ((code >> kHalfBinsLog2) != part) return;
    const uint32_t b = code & (kBins - 1u);
    const uint32_t addend = (uint32_t)n << (16u * (b & 1u));
    const uint32_t old = atomicAdd(bins + (b >> 1), addend);
    if (!(b & 1u) && (old & 0xffffu) + (uint32_t)n > 0xffffu) {
      atomicAdd(out + b, 65536);  // the low half wrapped ...
      atomicSub(out + b + 1, 1);  // ... and carried 1 into the high half
    }
    if (old + addend < old) atomicAdd(out + (b | 1u), 65536);  // high wrapped
  }
  __device__ __forceinline__ void flush() const {
    __syncthreads();
    for (uint32_t w = threadIdx.x; w < kBins / 2; w += blockDim.x) {
      const uint32_t v = bins[w];
      if (v & 0xffffu) atomicAdd(out + 2 * w, (int32_t)(v & 0xffffu));
      if (v >> 16) atomicAdd(out + 2 * w + 1, (int32_t)(v >> 16));
    }
  }
};

// How a launch is laid out for one of the three layouts.
struct BinPlan {
  int threads;
  size_t shared_bytes;
  uint32_t parts;  // blocks that share a stretch of input, one a part
};

inline BinPlan plan_global() { return {kThreads, 0, 1}; }
inline BinPlan plan_word(int k) {
  return {kWordThreads, sizeof(int32_t) << (2 * k), 1};
}
inline BinPlan plan_half(int k) {
  return {kHalfThreads, HalfBins::kBins * 2, 1u << (2 * k - kHalfBinsLog2)};
}

// Blocks for `items` grid-stride work items of one thread each, walked by
// every part: one wave at most, by the occupancy the runtime reports.
// Shared memory above the 48 KiB a kernel may use unasked is asked for
// here, at every launch (the attribute belongs to the device current at
// the call; it costs microseconds, and only batches of millions of windows
// take that path).
template <class Kernel>
cudaError_t plan_grid(Kernel kernel, const BinPlan& plan, int64_t items,
                      int* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (plan.shared_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.shared_bytes);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, plan.threads, plan.shared_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  const int64_t need =
      (items + plan.threads - 1) / plan.threads * (int64_t)plan.parts;
  int64_t cap = (int64_t)sms * per_sm / plan.parts * plan.parts;
  if (cap < plan.parts) cap = plan.parts;
  *blocks = (int)(need < cap ? need : cap);
  return cudaSuccess;
}

}  // namespace
