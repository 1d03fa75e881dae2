// K1 on Hopper: the exact histogram of the valid window codes of one batch
// over 4^k bins (k <= 10).
//
// Replaces findkmer_tpu/ops/pallas/histogram_kernel.py::histogram_pallas.
// The TPU kernel splits each code into hi/lo halves and bins them with an
// int8 one-hot outer product on the MXU, because the TPU has no scatter.
// Hopper has fast integer atomics, so this kernel bins each window directly.
//
// What bounds it on this card, and what the design does about it: 5 B are
// read a window (an int32 code and a validity byte: 335 MB a batch, 0.1 ms
// of device memory) and one atomic is done a valid window.  The atomics
// are the larger cost, so they go to block-private bins in shared memory
// wherever bins.cuh has a layout for them (k <= 9), and to the L2-resident
// global table for k = 10 and for small batches; the caller picks
// (`shared`).  At k = 9 the four parts of the bins read the input four
// times, which the bytes then bound.  The reads are 16 bytes of codes and
// 4 of flags a thread a step, neighbouring threads on neighbouring
// addresses; a batch whose pointers are not aligned so, and the last n % 4
// windows, take the one-window loop.  Hot bins (poly-A runs, repeats)
// serialise their atomics on one address; warp-aggregated atomics are
// later work.
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; it returns cudaGetLastError() so the wrapper can raise.

#include <cstdint>

#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

// Validity is tested before the code is used: the codes of invalid windows
// are arbitrary.  A valid code outside [0, nbins) is dropped rather than
// written out of bounds.  The first `quads` groups of four windows are read
// as vectors, the windows from 4 * quads on one by one; the blocks that
// share blockIdx.x / parts walk the same windows, one for each part of the
// bins.
template <class Bins>
__global__ void __launch_bounds__(Bins::kBlock)
hist(const int32_t* __restrict__ codes, const uint8_t* __restrict__ valid,
     int64_t n, int64_t quads, int k, uint32_t parts,
     int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const Bins bins(out, smem, k, blockIdx.x % parts);
  const uint32_t nbins = 1u << (2 * k);
  const int64_t stride = (int64_t)(gridDim.x / parts) * blockDim.x;
  const int64_t start =
      (int64_t)(blockIdx.x / parts) * blockDim.x + threadIdx.x;
  for (int64_t q = start; q < quads; q += stride) {
    const int4 c = __ldg((const int4*)codes + q);
    const uint32_t f = __ldg((const uint32_t*)valid + q);
    if ((f & 0xffu) && (uint32_t)c.x < nbins) bins.add((uint32_t)c.x, 1);
    if ((f & 0xff00u) && (uint32_t)c.y < nbins) bins.add((uint32_t)c.y, 1);
    if ((f & 0xff0000u) && (uint32_t)c.z < nbins) bins.add((uint32_t)c.z, 1);
    if ((f & 0xff000000u) && (uint32_t)c.w < nbins) bins.add((uint32_t)c.w, 1);
  }
  for (int64_t i = 4 * quads + start; i < n; i += stride) {
    if (valid[i]) {
      const uint32_t c = (uint32_t)codes[i];
      if (c < nbins) bins.add(c, 1);
    }
  }
  bins.flush();
}

template <class Bins>
int launch(const BinPlan& plan, const int32_t* codes, const uint8_t* valid,
           int64_t n, int k, int32_t* out, cudaStream_t s) {
  const bool aligned =
      ((uintptr_t)codes & 15u) == 0 && ((uintptr_t)valid & 3u) == 0;
  const int64_t quads = aligned ? n / 4 : 0;
  int blocks = 0;
  const cudaError_t err =
      plan_grid(hist<Bins>, plan, aligned ? (n + 3) / 4 : n, &blocks);
  if (err != cudaSuccess) return (int)err;
  hist<Bins><<<blocks, plan.threads, plan.shared_bytes, s>>>(
      codes, valid, n, quads, k, plan.parts, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out (4^k int32) += histogram of codes[valid].
// codes: n int32; valid: n bytes, 0 or 1 (a torch bool tensor qualifies).
// shared: 1 counts in block-private shared-memory bins (k <= 9), 0 with
// atomics on out itself.
extern "C" int fk_histogram(const void* codes, const void* valid, int64_t n,
                            void* out, int k, int shared, void* stream) {
  if (k < 1 || k > kMaxK || n < 0 || (shared && k > kSharedMaxK)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)codes;
  const uint8_t* v = (const uint8_t*)valid;
  int32_t* o = (int32_t*)out;
  if (!shared) return launch<GlobalBins>(plan_global(), c, v, n, k, o, s);
  if (k <= kWordMaxK) return launch<WordBins>(plan_word(k), c, v, n, k, o, s);
  return launch<HalfBins>(plan_half(k), c, v, n, k, o, s);
}

extern "C" const char* fk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
