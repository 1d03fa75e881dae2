// K1 on Hopper: the exact histogram of the valid window codes of one batch
// over 4^k bins (k <= 10).
//
// Replaces findkmer_tpu/ops/pallas/histogram_kernel.py::histogram_pallas.
// The TPU kernel splits each code into hi/lo halves and bins them with an
// int8 one-hot outer product on the MXU, because the TPU has no scatter.
// Hopper has fast integer atomics, so this kernel bins each window directly,
// with the binning of bins.cuh: a private shared-memory histogram per block
// for k <= 6, atomics straight into the global table for any k (the only
// choice for k = 7..10).  The caller picks one (the wrapper takes shared
// for k <= 6, where it is the faster of the two; both are timed at k = 4
// and 6 by chip_smoke.py).
//
// Bound: about 5 B read per window (int32 code + 1 B validity flag) plus one
// atomic per valid window.  Hot bins (poly-A runs, repeats) serialise their
// atomics on one address; warp-aggregated atomics are later work.
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; it returns cudaGetLastError() so the wrapper can raise.

#include <cstdint>

#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

// Validity is tested before the code is read: the codes of invalid windows
// are arbitrary.  A valid code outside [0, nbins) is dropped rather than
// written out of bounds.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
hist(const int32_t* __restrict__ codes, const uint8_t* __restrict__ valid,
     int64_t n, uint32_t nbins, int32_t* __restrict__ out) {
  __shared__ int32_t smem[kShared ? kSharedBins : 1];
  int32_t* bins = kShared ? smem : out;
  if (kShared) bins_zero(smem, nbins);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (valid[i]) {
      const uint32_t c = (uint32_t)codes[i];
      if (c < nbins) atomicAdd(&bins[c], 1);
    }
  }
  if (kShared) bins_flush(smem, nbins, out);
}

}  // namespace

// out (4^k int32, zeroed by the caller) += histogram of codes[valid].
// codes: n int32; valid: n bytes, 0 or 1 (a torch bool tensor qualifies).
// shared: 1 runs the shared-memory kernel (k <= 6 only), 0 the global one.
extern "C" int fk_histogram(const void* codes, const void* valid, int64_t n,
                            void* out, int k, int shared, void* stream) {
  if (k < 1 || k > kMaxK || n < 0 || (shared && k > kSharedMaxK)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  int blocks = 0;
  const cudaError_t err = grid_blocks(n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const uint32_t nbins = 1u << (2 * k);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)codes;
  const uint8_t* v = (const uint8_t*)valid;
  int32_t* o = (int32_t*)out;
  if (shared) {
    hist<true><<<blocks, kThreads, 0, s>>>(c, v, n, nbins, o);
  } else {
    hist<false><<<blocks, kThreads, 0, s>>>(c, v, n, nbins, o);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* fk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
