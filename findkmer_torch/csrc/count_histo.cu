// C3: the count-of-counts of a flat array of k-mer counts, for `histo`.
//
// h[m] is the number of entries whose count, clipped to max_count, is m;
// entries of count 0 (a dense table's empty bins, a store's holes) are
// skipped, so h[0] is 0.  The input is int32 or int64, the output
// max_count + 1 uint64 bins, zeroed by the caller.  Only those bins cross
// to the host: `histo` reads no code of the spectrum.
//
// Real spectra are skewed.  In a read set most distinct k-mers are the
// sequencing errors of bin 1, and most of the rest fall in a few coverage
// bins, so the adds of a warp land on a handful of addresses.  Two things
// keep those hot bins from serialising it:
//
//   * Each warp aggregates before it adds: `__match_any_sync` groups the
//     lanes that hold the same bin, and the lowest of them adds the
//     group's size once.  A warp of 32 ones is one atomic, not 32.
//   * A block keeps private uint32 bins in dynamic shared memory wherever
//     (max_count + 1) * 4 bytes fit a block's opt-in limit (the default
//     --max-count 10000 takes 40 KB; an H100 fits up to ~58 K bins), so
//     the atomics are served by 132 SMs side by side, not by the L2, and
//     flushes each nonzero bin once into the global table at its end (as
//     bins.cuh's WordBins does for the window histograms).  Above that
//     reach the same walk adds straight into the global bins.
//
// A launch is one wave of persistent blocks (bins.cuh's `plan_grid`),
// each walking 16-byte vectors of the input with a grid stride; the
// unaligned head and the tail of fewer than one vector are read by block
// 0's first warp.  A block's private bin holds at most the entries the
// block reads, under 2^32 for any array a card holds.  Every step is an
// integer add, so the bins are exact in any order of the threads.

#include <cstdint>

#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

constexpr int kHistoThreads = 512;
constexpr int kVecBytes = 16;

// The bin of one count: 0 (nothing to add) for count <= 0.
template <class T>
__device__ __forceinline__ uint32_t clip_bin(T c, uint32_t max_count) {
  if (c <= 0) return 0u;
  return (uint64_t)c >= max_count ? max_count : (uint32_t)c;
}

// Every lane of the warp calls it with its bin (0: none); each group of
// lanes with one nonzero bin adds its size once, through its lowest lane.
template <class Bins>
__device__ __forceinline__ void warp_add(const Bins& bins, uint32_t b) {
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  if (b != 0u && (int)(threadIdx.x & 31u) == __ffs(peers) - 1)
    bins.add(b, (uint32_t)__popc(peers));
}

struct SharedCountBins {
  unsigned long long* out;
  uint32_t* bins;
  uint32_t max_count;

  // Every thread of the block constructs it (zeroing, then a barrier).
  __device__ SharedCountBins(unsigned long long* out_, uint32_t* smem,
                             uint32_t max_count_)
      : out(out_), bins(smem), max_count(max_count_) {
    for (uint32_t b = threadIdx.x; b <= max_count; b += blockDim.x)
      bins[b] = 0u;
    __syncthreads();
  }
  __device__ __forceinline__ void add(uint32_t b, uint32_t n) const {
    atomicAdd(bins + b, n);
  }
  // Every thread of the block calls it, after its last add.
  __device__ __forceinline__ void flush() const {
    __syncthreads();
    for (uint32_t b = threadIdx.x + 1u; b <= max_count; b += blockDim.x) {
      const uint32_t v = bins[b];
      if (v) atomicAdd(out + b, (unsigned long long)v);
    }
  }
};

struct GlobalCountBins {
  unsigned long long* out;

  __device__ GlobalCountBins(unsigned long long* out_, uint32_t*, uint32_t)
      : out(out_) {}
  __device__ __forceinline__ void add(uint32_t b, uint32_t n) const {
    atomicAdd(out + b, (unsigned long long)n);
  }
  __device__ __forceinline__ void flush() const {}
};

// Loop bounds are the same for every lane of a warp (a block's stride
// base, or the warp-wide head-and-tail round), so `warp_add` always meets
// the whole warp.
template <class Bins, class T>
__global__ void __launch_bounds__(kHistoThreads)
    count_histo(const T* __restrict__ counts, int64_t head, int64_t nvec,
                int64_t tail_at, int64_t tail, uint32_t max_count,
                unsigned long long* __restrict__ out) {
  constexpr int kPer = kVecBytes / sizeof(T);
  extern __shared__ uint32_t histo_smem[];
  const Bins bins(out, histo_smem, max_count);
  const uint4* vec = reinterpret_cast<const uint4*>(counts + head);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t at = (int64_t)blockIdx.x * blockDim.x; at < nvec;
       at += stride) {
    const int64_t i = at + threadIdx.x;
    T v[kPer];
    if (i < nvec) {
      const uint4 w = vec[i];
      const T* p = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = p[j];
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) warp_add(bins, clip_bin(v[j], max_count));
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // head + tail < 2 * kPer <= 8 entries, one a lane
    const int64_t t = threadIdx.x;
    T c = 0;
    if (t < head)
      c = counts[t];
    else if (t - head < tail)
      c = counts[tail_at + (t - head)];
    warp_add(bins, clip_bin(c, max_count));
  }
  bins.flush();
}

template <class Bins, class T>
cudaError_t launch(const T* counts, int64_t n, uint32_t max_count,
                   unsigned long long* out, size_t shared_bytes,
                   cudaStream_t stream) {
  constexpr int64_t kPer = kVecBytes / sizeof(T);
  const int64_t misalign = (int64_t)((uintptr_t)counts % kVecBytes);
  int64_t head = misalign ? (kVecBytes - misalign) / (int64_t)sizeof(T) : 0;
  if (head > n) head = n;
  const int64_t nvec = (n - head) / kPer;
  const int64_t tail_at = head + nvec * kPer;
  const int64_t tail = n - tail_at;
  auto kernel = count_histo<Bins, T>;
  int blocks = 0;
  cudaError_t err = plan_grid(
      kernel, BinPlan{kHistoThreads, shared_bytes, 1u}, nvec, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks < 1) blocks = 1;  // the head and tail
  kernel<<<blocks, kHistoThreads, shared_bytes, stream>>>(
      counts, head, nvec, tail_at, tail, max_count, out);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(const T* counts, int64_t n, uint32_t max_count,
                     unsigned long long* out, bool shared,
                     cudaStream_t stream) {
  if (shared)
    return launch<SharedCountBins>(counts, n, max_count, out,
                                   ((size_t)max_count + 1) * sizeof(uint32_t),
                                   stream);
  return launch<GlobalCountBins>(counts, n, max_count, out, 0, stream);
}

}  // namespace

// The largest max_count whose bins fit one block's shared memory on the
// current device (its opt-in limit), into *out.
extern "C" int fk_count_histo_shared_max(int64_t* out) {
  int dev = 0;
  int bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  *out = (int64_t)(bytes / (int)sizeof(uint32_t)) - 1;
  return 0;
}

// out[0 .. max_count] += the count-of-counts of counts[0 .. n) (count_bytes
// 4 or 8), on `stream`.  shared: 1 private bins in shared memory (they
// must fit: fk_count_histo_shared_max), 0 global bins.  1 <= max_count <
// 2^31 - 1.
extern "C" int fk_count_histo(const void* counts, int64_t n, int count_bytes,
                              int64_t max_count, void* out, int shared,
                              void* stream) {
  if (n < 0 || max_count < 1 || max_count >= INT32_MAX ||
      (count_bytes != 4 && count_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  auto* bins = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (count_bytes == 4)
    return (int)dispatch(static_cast<const int32_t*>(counts), n,
                         (uint32_t)max_count, bins, shared != 0, s);
  return (int)dispatch(static_cast<const int64_t*>(counts), n,
                       (uint32_t)max_count, bins, shared != 0, s);
}
