// C1 on Hopper: the sparse path's window extraction.  The 2-bit wire of a
// batch in, the code of every window of every row out, in the residue-
// interleaved slot order of findkmer_torch/ops/window.py::
// window_codes_packed (the plain version, which this kernel equals slot
// for slot).
//
// Replaces the XLA fusion of findkmer_tpu/ops/window.py:201
// window_codes_packed.  That is not a Pallas kernel: under jax.jit XLA
// fuses it into the sparse ingest (findkmer_tpu/models/counter.py), so the
// TPU runs it as one program.  Run eagerly in PyTorch the same arithmetic
// is a loop over 16 residues of about 25 elementwise ops each: ~400
// launches a batch, each a trip through device memory.
//
// Layout (the plain version's, which the filter's hit bitmap reads back in
// window order, so it is not free):
//   packed    (B, nbp) bytes, 4 bases a byte, MSB first: a big-endian
//             2-bit stream; validbits (B, nbv) bytes, 1 bit a base, MSB
//             first.  Bytes past a row's end read as zeros.
//   out       16 * B * NW codes; slot (r * B + b) * NW + w is the window
//             that starts at base 16 w + r of row b.  NW is the caller's
//             (ops/window.py::packed_slots: the row's words, trimmed to
//             its true length R).  int32 codes for k <= 15, int64 above;
//             an invalid window is the dtype's max (the sentinel).
//
// What bounds it on this card: the bytes.  The wire is read once (3/8 B a
// base) and the codes written once (4 or 8 B a slot) at 3.35 TB/s:
//   * a production k=21 batch, 1024 x (65536 + 20) bases: ~25 MB in,
//     537 MB out, ~0.17 ms;
//   * the same at k=15 (int32 codes): ~0.09 ms;
//   * a filter batch of 256 x (65536 + 20): ~0.04 ms;
//   * `bench`'s ingest of 32 x (16384 + 20): 4.4 MB, ~1.3 us, so a launch
//     bounds it there.
// The arithmetic is ~20 integer instructions a slot, far under the bytes.
//
// What the design does about that bound: the output is 95% of the bytes,
// so the stores decide.  One thread takes one (row b, word w): it loads
// the row's words w, w+1, w+2 of the wire and halfwords w, w+1, w+2 of the
// validity (bytes, through the read-only cache; neighbouring threads share
// their lines), then makes its 16 residues in registers: the code from a
// funnel shift of two words (three for k > 16), the validity from the top
// k bits of the shifted validity stream, and for canonical the reverse
// complement by a reversal of the complemented code's 2-bit groups
// (__brev / __brevll and a swap of neighbouring bits).  Neighbouring
// threads take neighbouring w, so each of the 16 stores of a warp is one
// contiguous run of 128 or 256 bytes.  Indices are 64-bit.  Wider stores,
// TMA and the filter's membership test fused in are later work.
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; it returns cudaGetLastError() so the wrapper can raise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 31;
constexpr int kResidues = 16;  // bases a 32-bit word of the wire
constexpr int kBlock = 256;

// Bytes i .. i + n - 1 of a row as one big-endian value; bytes at or past
// `nbytes` read as zeros.
template <int n>
__device__ __forceinline__ uint32_t be_bytes(const uint8_t* row,
                                             int64_t nbytes, int64_t i) {
  uint32_t x = 0u;
#pragma unroll
  for (int q = 0; q < n; ++q) {
    x = (x << 8) | (i + q < nbytes ? (uint32_t)__ldg(row + i + q) : 0u);
  }
  return x;
}

// The order of the sixteen 2-bit groups of a word reversed.
__device__ __forceinline__ uint32_t reverse_bases(uint32_t x) {
  const uint32_t y = __brev(x);
  return ((y & 0x55555555u) << 1) | ((y >> 1) & 0x55555555u);
}

// The same for the thirty-two groups of a 64-bit word.
__device__ __forceinline__ uint64_t reverse_bases(uint64_t x) {
  const uint64_t y = __brevll(x);
  return ((y & 0x5555555555555555ull) << 1) |
         ((y >> 1) & 0x5555555555555555ull);
}

// The empty-slot marker of a code type: its max.
template <class Code>
struct Sentinel;
template <>
struct Sentinel<int32_t> {
  static constexpr int32_t value = 0x7fffffff;
};
template <>
struct Sentinel<int64_t> {
  static constexpr int64_t value = 0x7fffffffffffffffll;
};

// Code: the output type (int32 or int64).  kWide: k > 16, the code spans
// three words of the wire.  k = 16 takes the narrow path into int64.
template <class Code, bool kWide, bool kCanonical>
__global__ void __launch_bounds__(kBlock)
window_codes(const uint8_t* __restrict__ packed,
             const uint8_t* __restrict__ validbits, int64_t B, int64_t nbp,
             int64_t nbv, int64_t NW, int k, Code* __restrict__ out) {
  const Code sentinel = Sentinel<Code>::value;
  const uint32_t full = (1u << k) - 1u;  // k <= 31
  const int64_t units = B * NW;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < units; g += stride) {
    const int64_t b = g / NW;
    const int64_t w = g - b * NW;
    const uint8_t* pr = packed + b * nbp;
    const uint32_t w0 = be_bytes<4>(pr, nbp, 4 * w);
    const uint32_t w1 = be_bytes<4>(pr, nbp, 4 * w + 4);
    const uint32_t w2 = kWide ? be_bytes<4>(pr, nbp, 4 * w + 8) : 0u;
    const uint8_t* vr = validbits + b * nbv;
    // validity halfwords w, w+1, w+2, the first on top of 48 bits
    const uint64_t v48 = ((uint64_t)be_bytes<2>(vr, nbv, 2 * w) << 32) |
                         ((uint64_t)be_bytes<2>(vr, nbv, 2 * w + 2) << 16) |
                         (uint64_t)be_bytes<2>(vr, nbv, 2 * w + 4);
    Code* o = out + b * NW + w;
    const int64_t plane = B * NW;  // slots between residues r and r + 1
#pragma unroll
    for (int r = 0; r < kResidues; ++r) {
      // bases 16 w + r on: validity of the top k, code of the top 2k bits
      const uint32_t t = (uint32_t)(v48 >> (16 - r));
      const bool valid = (t >> (32 - k)) == full;
      const uint32_t a = __funnelshift_l(w1, w0, 2 * r);
      Code code;
      if (kWide) {
        const uint32_t a2 = __funnelshift_l(w2, w1, 2 * r);
        const int sh = 64 - 2 * k;  // 2 .. 30
        uint64_t c = (((uint64_t)a << 32) | a2) >> sh;
        if (kCanonical) {
          const uint64_t rc = reverse_bases(~c) >> sh;
          c = rc < c ? rc : c;
        }
        code = (Code)c;
      } else {
        const int sh = 32 - 2 * k;  // 0 .. 30
        uint32_t c = a >> sh;
        if (kCanonical) {
          const uint32_t rc = reverse_bases(~c) >> sh;
          c = rc < c ? rc : c;
        }
        code = (Code)c;
      }
      o[r * plane] = valid ? code : sentinel;
    }
  }
}

template <class Code, bool kWide>
int launch(const uint8_t* packed, const uint8_t* validbits, int64_t B,
           int64_t nbp, int64_t nbv, int64_t NW, int k, bool canonical,
           void* out, cudaStream_t s) {
  const int64_t units = B * NW;
  const int64_t want = (units + kBlock - 1) / kBlock;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  if (canonical) {
    window_codes<Code, kWide, true><<<blocks, kBlock, 0, s>>>(
        packed, validbits, B, nbp, nbv, NW, k, (Code*)out);
  } else {
    window_codes<Code, kWide, false><<<blocks, kBlock, 0, s>>>(
        packed, validbits, B, nbp, nbv, NW, k, (Code*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (16 * B * NW codes: int32 for k <= 15, int64 above) = the window
// codes of the wire packed (B, nbp), validbits (B, nbv), slot
// (r * B + b) * NW + w for the window at base 16 w + r of row b.  NW words
// a row, at most ceil(nbp / 4) and ceil(nbv / 2).
extern "C" int fk_window_codes_packed(const void* packed,
                                      const void* validbits, int64_t B,
                                      int64_t nbp, int64_t nbv, int64_t NW,
                                      void* out, int k, int canonical,
                                      void* stream) {
  if (k < 1 || k > kMaxK || B < 0 || NW < 0 || 4 * NW > nbp + 3 ||
      2 * NW > nbv + 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || NW == 0) return (int)cudaGetLastError();
  const uint8_t* p = (const uint8_t*)packed;
  const uint8_t* v = (const uint8_t*)validbits;
  cudaStream_t s = (cudaStream_t)stream;
  const bool c = canonical != 0;
  if (k <= 15) return launch<int32_t, false>(p, v, B, nbp, nbv, NW, k, c, out, s);
  if (k == 16) return launch<int64_t, false>(p, v, B, nbp, nbv, NW, k, c, out, s);
  return launch<int64_t, true>(p, v, B, nbp, nbv, NW, k, c, out, s);
}
