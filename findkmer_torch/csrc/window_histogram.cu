// K2 on Hopper: the fused window histogram.  Rows of bases in, the exact
// (4^k,) int32 histogram of all their valid k-mer windows out (k <= 10),
// with no window code ever written to memory.
//
// Replaces findkmer_tpu/ops/pallas/histogram_kernel.py::
// fused_window_histogram (body _fused_kernel).  The TPU kernel builds every
// window's code from k shifted slices of a VMEM row tile, then bins the
// codes with a hi/lo one-hot outer product on the MXU.  On Hopper the
// natural shape is a rolling code in registers and an atomic per window:
//
//   * Each thread owns a run of kRun consecutive windows of one row.  It
//     reads the k-1 halo bases before its first window's last base, then
//     one base per window, and keeps three rolling values in registers:
//       forward code   ((code << 2) | b) & (4^k - 1)
//       reverse compl. (rc >> 2) | ((3 - b) << 2(k-1))
//       valid run      consecutive valid bases, 0 after an invalid one
//     The window ending at a base counts when the valid run is >= k (which
//     also means the thread has read all k of its bases); with canonical
//     it counts min(code, rc).
//   * Consecutive equal codes (homopolymer runs: poly-A) are summed in a
//     register and added with one atomic, so a hot bin does not serialise
//     one atomic per window.
//   * Binning is K1's (bins.cuh): a private shared-memory histogram per
//     block for k <= 6, global atomics into the L2-resident table for
//     k = 7..10.
//
// Two sources of bases share the one device body:
//   rows:   (B, R) bytes, one base a byte; a byte < 4 is a valid base b & 3,
//           any byte from 4 to 255 is invalid.
//   packed: the 2-bit wire the pipeline stages (src/native/encode.c,
//           findkmer_torch/ops/window.py unpack_rows): (B, nbp) bytes of
//           4 bases, MSB first, and (B, nbv) validity bytes of 8 bits, MSB
//           first; R <= 4 nbp is the true row length and no window reaches
//           past it.
// Window i of a row covers bases i .. i+k-1, i < W = R - k + 1.
//
// Bound: one atomic per valid window (the bases are 1 B or 3/8 B a window,
// read through L1, each byte by one thread).  A (1024, 65536 + k - 1) batch
// counts at most 2^26 windows, so no int32 bin can overflow.
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; it returns cudaGetLastError() so the wrapper can raise.

#include <cstdint>

#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

constexpr int kRun = 64;  // windows per thread

struct RowsSource {
  const uint8_t* rows;
  int64_t R;

  __device__ __forceinline__ void at(int64_t row, int64_t p, uint32_t* base,
                                     bool* valid) const {
    const uint8_t c = __ldg(rows + row * R + p);
    *base = c & 3u;
    *valid = c < 4;
  }
};

struct PackedSource {
  const uint8_t* packed;
  const uint8_t* validbits;
  int64_t nbp;  // packed bytes per row
  int64_t nbv;  // validity bytes per row

  __device__ __forceinline__ void at(int64_t row, int64_t p, uint32_t* base,
                                     bool* valid) const {
    const uint32_t w = __ldg(packed + row * nbp + (p >> 2));
    const uint32_t v = __ldg(validbits + row * nbv + (p >> 3));
    *base = (w >> (6 - 2 * (p & 3))) & 3u;
    *valid = (v >> (7 - (p & 7))) & 1u;
  }
};

template <class Source, bool kShared, bool kCanonical>
__global__ void __launch_bounds__(kThreads)
window_hist(Source src, int64_t B, int64_t W, int k,
            int32_t* __restrict__ out) {
  __shared__ int32_t smem[kShared ? kSharedBins : 1];
  const uint32_t nbins = 1u << (2 * k);
  int32_t* bins = kShared ? smem : out;
  if (kShared) bins_zero(smem, nbins);
  const uint32_t mask = nbins - 1u;
  const int rc_shift = 2 * (k - 1);
  const int64_t runs_per_row = (W + kRun - 1) / kRun;
  const int64_t runs = B * runs_per_row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < runs;
       g += stride) {
    const int64_t row = g / runs_per_row;
    const int64_t first = (g - row * runs_per_row) * kRun;  // first window
    const int64_t end = first + kRun < W ? first + kRun : W;  // one past
    uint32_t code = 0;
    uint32_t rc = 0;
    int valid_run = 0;
    uint32_t held = 0;  // code of the pending run of equal windows
    int32_t held_n = 0;
    // bases first .. end + k - 2: the last base of window end - 1
    for (int64_t p = first; p < end + k - 1; ++p) {
      uint32_t b;
      bool v;
      src.at(row, p, &b, &v);
      code = ((code << 2) | b) & mask;
      if (kCanonical) rc = (rc >> 2) | ((3u - b) << rc_shift);
      valid_run = v ? valid_run + 1 : 0;
      if (valid_run >= k) {  // the window ending at p is valid
        const uint32_t c = kCanonical && rc < code ? rc : code;
        if (c == held) {
          ++held_n;
        } else {
          if (held_n) atomicAdd(&bins[held], held_n);
          held = c;
          held_n = 1;
        }
      }
    }
    if (held_n) atomicAdd(&bins[held], held_n);
  }
  if (kShared) bins_flush(smem, nbins, out);
}

template <class Source, bool kShared>
void launch_body(const Source& src, int64_t B, int64_t W, int k,
                 bool canonical, int blocks, int32_t* out, cudaStream_t s) {
  if (canonical) {
    window_hist<Source, kShared, true><<<blocks, kThreads, 0, s>>>(
        src, B, W, k, out);
  } else {
    window_hist<Source, kShared, false><<<blocks, kThreads, 0, s>>>(
        src, B, W, k, out);
  }
}

template <class Source>
int launch(const Source& src, int64_t B, int64_t R, void* out, int k,
           int canonical, void* stream) {
  if (k < 1 || k > kMaxK || B < 0 || R < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t W = R - k + 1;
  if (B == 0 || W <= 0) return (int)cudaGetLastError();
  int blocks = 0;
  const cudaError_t err = grid_blocks(B * ((W + kRun - 1) / kRun), &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  if (k <= kSharedMaxK) {
    launch_body<Source, true>(src, B, W, k, canonical != 0, blocks, o, s);
  } else {
    launch_body<Source, false>(src, B, W, k, canonical != 0, blocks, o, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (4^k int32, zeroed by the caller) += histogram of the valid windows
// of rows (B, R) bytes.
extern "C" int fk_window_histogram(const void* rows, int64_t B, int64_t R,
                                   void* out, int k, int canonical,
                                   void* stream) {
  const RowsSource src{(const uint8_t*)rows, R};
  return launch(src, B, R, out, k, canonical, stream);
}

// The same from the 2-bit wire: packed (B, nbp), validbits (B, nbv), true
// row length R <= 4 nbp <= 8 nbv.
extern "C" int fk_window_histogram_packed(const void* packed,
                                          const void* validbits, int64_t B,
                                          int64_t nbp, int64_t nbv, int64_t R,
                                          void* out, int k, int canonical,
                                          void* stream) {
  if (R > 4 * nbp || R > 8 * nbv) return (int)cudaErrorInvalidValue;
  const PackedSource src{(const uint8_t*)packed, (const uint8_t*)validbits,
                         nbp, nbv};
  return launch(src, B, R, out, k, canonical, stream);
}
