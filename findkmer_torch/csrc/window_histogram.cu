// K2 on Hopper: the fused window histogram.  Rows of bases in, the exact
// (4^k,) int32 histogram of all their valid k-mer windows out (k <= 10),
// with no window code ever written to memory.
//
// Replaces findkmer_tpu/ops/pallas/histogram_kernel.py::
// fused_window_histogram (body _fused_kernel).  The TPU kernel builds every
// window's code from k shifted slices of a VMEM row tile, then bins the
// codes with a hi/lo one-hot outer product on the MXU.  On Hopper the
// natural shape is a run of the row in each thread's registers and an
// atomic per window.
//
// What bounds it on this card, and what the design does about it:
//
//   * The bytes are nothing (3/8 B a window from the wire: 25 MB a batch,
//     microseconds of device memory).  The work is integer instructions,
//     which an SM executes at 64 a clock, and one atomic a window, so the
//     costs are the loads, the instructions a window and where the atomics
//     land.
//   * Loads.  A thread owns a run of kRun = 64 bases of one row and counts
//     the windows that END in its run; the kLoadHalo = 16 bases before the
//     run (at least k - 1) are only read.  64 bases are 16 B of packed
//     bases and 8 B of validity (64 B of a uint8 row): the thread fetches
//     them once, with aligned 16-byte loads, neighbouring threads on
//     neighbouring 16 bytes.  Rows of the wire start at any byte (a
//     production row is 16,386 packed and 8,193 validity bytes), so
//     `load_words` reads the aligned 16-byte units around its bytes and
//     shifts them into place; a unit is read only if it holds a byte of
//     the tensor, and a unit that holds one lies in the tensor's page.
//   * Instructions.  Nothing rolls from base to base.  The wire is the
//     codes already: with the run's 80 bases in five registers, first
//     base on top, the code of the window ending at base i is 2k bits of
//     two neighbouring registers, one funnel shift by a constant (the loop
//     over i is unrolled) and one AND.  The reverse complements come the
//     same way from a second copy of the registers, first base lowest,
//     complemented and shifted left by 2 (k - 1) once a run; canonical
//     counts the smaller of the two.  Which windows are valid is one
//     96-bit mask a run: the validity bits ANDed with themselves shifted
//     by 1 .. k - 1, in doubling steps; the halo of a row's first run and
//     the bases past the row's end are cleared in it, so no window leaves
//     its row.  The uint8 rows are packed into the same registers first
//     (a few instructions a base more).
//   * Consecutive equal codes (homopolymer runs: poly-A) are summed in a
//     register and added with one atomic, so a hot bin does not serialise
//     one atomic per window.
//   * Binning is bins.cuh's: block-private bins in shared memory for
//     k <= 9 (int32 up to k = 7, 16-bit halves at k = 8, four parts at
//     k = 9), atomics into the L2-resident table for k = 10 and for small
//     batches.  The caller picks private or global.
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
// A (1024, 65536 + k - 1) batch counts at most 2^26 windows, so no int32
// bin can overflow.
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; it returns cudaGetLastError() so the wrapper can raise.

#include <cstdint>

#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

constexpr int kRun = 64;       // bases a thread owns: 16 B of the wire
constexpr int kLoadHalo = 16;  // bases before them (>= kMaxK - 1): 4 B

// w[j] = bytes p + 4j .. p + 4j + 3, little-endian, for j < NW, fetched as
// the aligned 16-byte units that hold them.  A unit with no byte in
// [begin, end) is not read and counts as zeros.
template <int NW>
__device__ __forceinline__ void load_words(const uint8_t* p,
                                           const uint8_t* begin,
                                           const uint8_t* end,
                                           uint32_t (&w)[NW]) {
  constexpr int NQ = (4 * NW + 15 + 15) / 16;  // units, at any misalignment
  const uint32_t m = (uint32_t)((uintptr_t)p & 15u);
  const uint8_t* q = p - m;
  uint32_t a[4 * NQ + 3];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const uint8_t* u = q + 16 * i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (16u * i < m + 4u * NW && u + 16 > begin && u < end) {
      v = __ldg((const uint4*)u);
    }
    a[4 * i] = v.x;
    a[4 * i + 1] = v.y;
    a[4 * i + 2] = v.z;
    a[4 * i + 3] = v.w;
  }
  a[4 * NQ] = a[4 * NQ + 1] = a[4 * NQ + 2] = 0u;
  const uint32_t bits = 8u * (m & 3u);
#pragma unroll
  for (int j = 0; j < 4 * NQ; ++j) a[j] = __funnelshift_r(a[j], a[j + 1], bits);
#pragma unroll
  for (int j = 0; j < 4 * NQ; ++j) a[j] = (m & 4u) ? a[j + 1] : a[j];
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = (m & 8u) ? a[j + 2] : a[j];
}

// A run in registers, the same for both sources.  Base i of a run,
// 0 <= i < kLoadHalo + kRun, is base 64 c + i - kLoadHalo of its row.
struct Run {
  // The bases as the wire has them, 16 a word, the first in the top two
  // bits: the code of the window that ends at base i is the low 2k bits of
  // the 64-bit pair fwd[i / 16 - 1] : fwd[i / 16] shifted right by
  // 30 - 2 (i % 16), a funnel shift by a constant.
  uint32_t fwd[(kLoadHalo + kRun) / 16];
  // The same bases with the first in the low two bits.  Complemented and
  // shifted left by 2 (k - 1), they hold the reverse complement of the
  // window that ends at base i from bit 2 i on (`RcStream`).
  uint32_t rev[(kLoadHalo + kRun) / 16];
  // Bit i of the 96-bit valid[2] : valid[1] : valid[0]: base i is a valid
  // base of this row.
  uint32_t valid[3];
};

// The order of the sixteen 2-bit groups of a word reversed.
__device__ __forceinline__ uint32_t reverse_bases(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y & 0x55555555u) << 1) | ((y >> 1) & 0x55555555u);
}

// Clear the validity of the halo of a row's first run (those bases belong
// to the row before) and of the bases past the row's end.
__device__ __forceinline__ void clip_valid(Run* run, uint32_t c, int64_t R) {
  if (c == 0) run->valid[0] &= ~((1u << kLoadHalo) - 1u);
  const int64_t left = R - (int64_t)c * kRun;  // >= 1
  if (left < kRun) {
    const int n = (int)left + kLoadHalo;  // valid bits from 0 that stay
    if (n < 32) run->valid[0] &= (1u << n) - 1u;
    if (n < 64) run->valid[1] &= n <= 32 ? 0u : (1u << (n - 32)) - 1u;
    run->valid[2] &= n <= 64 ? 0u : (1u << (n - 64)) - 1u;
  }
}

struct RowsSource {
  const uint8_t* rows;
  int64_t B;
  int64_t R;

  __device__ __forceinline__ void load(int64_t row, uint32_t c,
                                       Run* run) const {
    constexpr int NW = (kLoadHalo + kRun) / 4;
    uint32_t w[NW];  // four bases a word, one a byte
    const uint8_t* p = rows + row * R + (int64_t)c * kRun - kLoadHalo;
    load_words(p, rows, rows + B * R, w);
    run->valid[0] = run->valid[1] = run->valid[2] = 0u;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      // the low two bits of the four bytes, gathered into one byte
      uint32_t t = w[j] & 0x03030303u;
      t = (t | (t >> 6)) & 0x000f000fu;
      t = (t | (t >> 12)) & 0xffu;
      if (j % 4 == 0) run->rev[j / 4] = 0u;
      run->rev[j / 4] |= t << (8 * (j % 4));
      // bit 7 of each byte: the byte is not a base (some bit above 1 set)
      const uint32_t z = w[j] & 0xfcfcfcfcu;
      const uint32_t bad = (((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z) >> 7;
      // bits 0, 8, 16, 24 gathered into bits 24..27 by one multiplication
      const uint32_t nib = (((bad & 0x01010101u) * 0x01020408u) >> 24) ^ 0xfu;
      run->valid[j / 8] |= nib << (4 * (j % 8));
    }
#pragma unroll
    for (int j = 0; j < NW / 4; ++j) run->fwd[j] = reverse_bases(run->rev[j]);
    clip_valid(run, c, R);
  }
};

struct PackedSource {
  const uint8_t* packed;
  const uint8_t* validbits;
  int64_t B;
  int64_t nbp;  // packed bytes per row
  int64_t nbv;  // validity bytes per row
  int64_t R;

  // The bits of each byte reversed: validity bytes are MSB first, and a
  // little-endian word of them then has base i at bit i.
  static __device__ __forceinline__ uint32_t bit_order(uint32_t x) {
    return __byte_perm(__brev(x), 0u, 0x0123u);
  }

  __device__ __forceinline__ void load(int64_t row, uint32_t c,
                                       Run* run) const {
    constexpr int NW = (kLoadHalo + kRun) / 16;
    uint32_t w[NW];
    const uint8_t* p = packed + row * nbp + (int64_t)c * (kRun / 4)
                       - kLoadHalo / 4;
    load_words(p, packed, packed + B * nbp, w);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      run->fwd[j] = __byte_perm(w[j], 0u, 0x0123u);  // big-endian
      run->rev[j] = reverse_bases(run->fwd[j]);
    }
    const uint8_t* pv = validbits + row * nbv + (int64_t)c * (kRun / 8)
                        - kLoadHalo / 8;
    uint32_t x[3];  // 2 bytes of the halo, 8 of the run, 2 unused
    load_words(pv, validbits, validbits + B * nbv, x);
    run->valid[0] = bit_order(x[0]);
    run->valid[1] = bit_order(x[1]);
    run->valid[2] = bit_order(x[2]) & 0xffffu;
    clip_valid(run, c, R);
  }
};

// The reverse complements of a run's windows: the complemented bases,
// first base lowest, shifted left by 2 (k - 1) over the word boundaries.
struct RcStream {
  uint32_t w[(kLoadHalo + kRun) / 16 + 1];

  __device__ __forceinline__ RcStream(const Run& run, int k) {
    constexpr int NW = (kLoadHalo + kRun) / 16;
    const uint32_t sh = 2u * (k - 1);  // < 32
    w[0] = ~run.rev[0] << sh;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      w[j] = __funnelshift_l(~run.rev[j - 1], ~run.rev[j], sh);
    }
    w[NW] = __funnelshift_l(~run.rev[NW - 1], 0u, sh);
  }
  // Of the window that ends at base i, before the mask to 2k bits.
  __device__ __forceinline__ uint32_t at(int i) const {
    return __funnelshift_r(w[i >> 4], w[(i >> 4) + 1], 2 * (i & 15));
  }
};

// units = B * runs_per_row runs, one a thread at a time; the blocks that
// share blockIdx.x / parts walk the same runs, one for each part of the
// bins.
template <class Source, class Bins, bool kCanonical>
__global__ void __launch_bounds__(Bins::kBlock)
window_hist(Source src, uint32_t units, uint32_t runs_per_row, int k,
            uint32_t parts, int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const Bins bins(out, smem, k, blockIdx.x % parts);
  const uint32_t mask = (1u << (2 * k)) - 1u;
  const uint32_t stride = gridDim.x / parts * blockDim.x;
  for (uint32_t g = blockIdx.x / parts * blockDim.x + threadIdx.x; g < units;
       g += stride) {
    const uint32_t row = g / runs_per_row;
    Run run;
    src.load(row, g - row * runs_per_row, &run);
    // Bit i of ends: the window that ends at base i is valid, which is
    // bits i - k + 1 .. i of the validity all set: the validity ANDed with
    // itself shifted left by 1 .. k - 1, in doubling steps.
    uint32_t ends[3] = {run.valid[0], run.valid[1], run.valid[2]};
    int cover = 1;  // ends covers this many bases behind each bit
    while (cover < k) {
      const int s = 2 * cover <= k ? cover : k - cover;
      ends[2] &= __funnelshift_l(ends[1], ends[2], s);
      ends[1] &= __funnelshift_l(ends[0], ends[1], s);
      ends[0] &= ends[0] << s;
      cover += s;
    }
    const RcStream rcs(run, kCanonical ? k : 1);
    uint32_t held = 0;  // code of the pending run of equal windows
    int32_t held_n = 0;
#pragma unroll
    for (int i = kLoadHalo; i < kLoadHalo + kRun; ++i) {
      if ((ends[i >> 5] >> (i & 31)) & 1u) {  // the window ending here
        uint32_t c = __funnelshift_r(run.fwd[i >> 4], run.fwd[(i >> 4) - 1],
                                     30 - 2 * (i & 15)) & mask;
        if (kCanonical) {
          const uint32_t rc = rcs.at(i) & mask;
          c = rc < c ? rc : c;
        }
        if (c == held) {
          ++held_n;
        } else {
          if (held_n) bins.add(held, held_n);
          held = c;
          held_n = 1;
        }
      }
    }
    if (held_n) bins.add(held, held_n);
  }
  bins.flush();
}

template <class Source, class Bins, bool kCanonical>
int launch_kernel(const Source& src, const BinPlan& plan, int64_t units,
                  int64_t runs_per_row, int k, int32_t* out, cudaStream_t s) {
  int blocks = 0;
  const cudaError_t err = plan_grid(window_hist<Source, Bins, kCanonical>,
                                    plan, units, &blocks);
  if (err != cudaSuccess) return (int)err;
  window_hist<Source, Bins, kCanonical>
      <<<blocks, plan.threads, plan.shared_bytes, s>>>(
          src, (uint32_t)units, (uint32_t)runs_per_row, k, plan.parts, out);
  return (int)cudaGetLastError();
}

template <class Source, class Bins>
int launch_bins(const Source& src, const BinPlan& plan, int64_t units,
                int64_t runs_per_row, int k, bool canonical, int32_t* out,
                cudaStream_t s) {
  return canonical ? launch_kernel<Source, Bins, true>(
                         src, plan, units, runs_per_row, k, out, s)
                   : launch_kernel<Source, Bins, false>(
                         src, plan, units, runs_per_row, k, out, s);
}

template <class Source>
int launch(const Source& src, int64_t B, int64_t R, void* out, int k,
           int canonical, int private_bins, void* stream) {
  if (k < 1 || k > kMaxK || B < 0 || R < 0 ||
      (private_bins && k > kSharedMaxK)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || R < k) return (int)cudaGetLastError();
  const int64_t runs_per_row = (R + kRun - 1) / kRun;
  const int64_t units = B * runs_per_row;
  if (units >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  const bool c = canonical != 0;
  if (!private_bins) {
    return launch_bins<Source, GlobalBins>(src, plan_global(), units,
                                           runs_per_row, k, c, o, s);
  }
  if (k <= kWordMaxK) {
    return launch_bins<Source, WordBins>(src, plan_word(k), units,
                                         runs_per_row, k, c, o, s);
  }
  return launch_bins<Source, HalfBins>(src, plan_half(k), units, runs_per_row,
                                       k, c, o, s);
}

}  // namespace

// out (4^k int32) += histogram of the valid windows of rows (B, R) bytes.
// private_bins: 1 counts in block-private shared-memory bins (k <= 9), 0
// with atomics on out itself.
extern "C" int fk_window_histogram(const void* rows, int64_t B, int64_t R,
                                   void* out, int k, int canonical,
                                   int private_bins, void* stream) {
  const RowsSource src{(const uint8_t*)rows, B, R};
  return launch(src, B, R, out, k, canonical, private_bins, stream);
}

// The same from the 2-bit wire: packed (B, nbp), validbits (B, nbv), true
// row length R <= 4 nbp <= 8 nbv.
extern "C" int fk_window_histogram_packed(const void* packed,
                                          const void* validbits, int64_t B,
                                          int64_t nbp, int64_t nbv, int64_t R,
                                          void* out, int k, int canonical,
                                          int private_bins, void* stream) {
  if (R > 4 * nbp || R > 8 * nbv) return (int)cudaErrorInvalidValue;
  const PackedSource src{(const uint8_t*)packed, (const uint8_t*)validbits,
                         B, nbp, nbv, R};
  return launch(src, B, R, out, k, canonical, private_bins, stream);
}
