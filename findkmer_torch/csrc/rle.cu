// C2 on Hopper: the run-length encoding of the sparse store's sorted rows.
//
// For every row of a (R, C) key matrix whose rows are sorted, the total of
// each run of equal keys lands at the run's last slot; every other slot,
// and every slot of a run of the sentinel (the key type's maximum), gets 0.
// Implicit mode (`ops/sparse.rle_pos_2d`): every slot counts 1, so the
// total is the run's length, written into a new output of the count type.
// Counted mode (`rle_val_2d`): the total is the sum of the run's counts,
// written IN PLACE over the counts.  Sums are taken modulo 2^64 and then
// cut to the count type, so a total is exact whenever it fits, however far
// a row's running sum goes: the int64 cumsum of the plain version does the
// same.  Keys are compared as signed integers with !=; a row's first slot
// always begins a run and its last always ends one, so rows never join.
// The plain version (`ops/cuda/rle_kernel.rle_rows_reference`) is the torch
// chain this kernel replaced, and the kernel equals it slot for slot.
//
// Replaces no Pallas kernel.  It stands in for the XLA scans of
// findkmer_tpu/ops/sparse.py rle_pos_2d / rle_val_2d (a cummax of the run
// starts, a cumsum differenced at them), which PyTorch runs eagerly as
// about a dozen launches over the whole store.  Its worst was the cummax:
// torch gives each row of an innermost-dim scan to one thread block, so the
// cross-row dedup's one row of 2^29 slots ran on one SM.
//
// What bounds it on this card: the bytes.  Keys read once, counts read
// once in counted mode, totals written once, at 3.35 TB/s: a (262144,
// 1024) int64 raw compaction 3 GiB, ~0.96 ms; the dedup's (1, 2^29) int64
// keys with int32 counts 8 GiB, ~2.6 ms.  The arithmetic is a few integer
// instructions and about a dozen warp shuffles a slot.
//
// What the design does about that bound: the store is one flat array of
// R * C slots in which every row start is a forced run start, cut into
// tiles of kTile = 4096 slots, one tile to a block of 256 threads.  So the
// shape decides only the number of tiles: rows of 768 to 2048 slots (a
// tile holds several, or a row straddles two) and the dedup's one row
// (131072 tiles) run the same code.
//   * Loads and stores are 16 bytes a thread (8 for the int32 counts beside
//     int64 keys), neighbouring lanes on neighbouring addresses: a warp
//     owns 512 consecutive slots, 32 lanes x V slots (V = 16 B / key) a
//     round, kItems / V rounds.  The lane's neighbours across its V slots
//     come by shuffle; the slot before a warp's span and the one after it
//     are one load each.  Every input slot is read into registers before
//     any total is written, so counted mode can overwrite its counts.
//   * A run is a pair (f, s): whether a run start lies in the stretch, and
//     the sum since the last one (or of all of it).  Pairs combine
//     associatively (a then b: f = a.f | b.f, s = b.f ? b.s : a.s + b.s),
//     so a warp scans its rounds with shuffles and the block combines its
//     eight warps through shared memory.
//   * Tiles link by decoupled look-back.  A tile takes its index from a
//     counter (so every earlier tile is already running), publishes its
//     pair, and looks back only if its first slot continues a run.  A tile
//     that holds a run start publishes its inclusive sum at once; one that
//     holds none publishes its aggregate, looks back, then its inclusive
//     sum.  The look-back reads 32 predecessors at a time (a lane each) and
//     stops at the nearest one that is inclusive: runs are far shorter
//     than a tile on every store, so it ends at the tile before.  A run
//     across many tiles (a row of one key) walks back 32 tiles a step.
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// The launch goes on the caller's stream, allocates nothing (the wrapper
// gives it the tile status words, fk_rle_rows_status_words of them) and
// does not synchronise; it returns cudaGetLastError() so the wrapper can
// raise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBlock = 32 * kWarps;
constexpr int kItems = 16;  // slots a thread
constexpr int64_t kTile = (int64_t)kBlock * kItems;
constexpr int64_t kWarpSpan = 32 * kItems;
constexpr unsigned kFull = 0xffffffffu;
// a tile's status word: nothing yet, its aggregate, its inclusive sum
constexpr uint64_t kAggregate = 1, kInclusive = 2;

template <class T>
struct Sentinel;
template <>
struct Sentinel<int32_t> {
  static constexpr int32_t value = 0x7fffffff;
};
template <>
struct Sentinel<int64_t> {
  static constexpr int64_t value = 0x7fffffffffffffffll;
};

// A stretch of slots: whether a run starts in it, and the sum since the
// last run start in it (of the whole stretch if none does).
struct Run {
  bool f;
  uint64_t s;
};

__device__ __forceinline__ Run combine(Run a, Run b) {
  return {a.f || b.f, b.f ? b.s : a.s + b.s};
}

__device__ __forceinline__ Run shfl_up(Run r, int d) {
  return {__shfl_up_sync(kFull, (int)r.f, d) != 0,
          __shfl_up_sync(kFull, r.s, d)};
}

// N slots of T in one access: 8, 16 or 32 bytes (two 16-byte ones).
template <class T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Vec {
  T v[N];
};

// Slots i .. i + N - 1 of p into x; slots at or past n read as fill.
template <class T, int N>
__device__ __forceinline__ void load(const T* p, int64_t i, int64_t n,
                                     bool vec, T (&x)[N], T fill) {
  if (vec && i + N <= n) {
    const Vec<T, N> w = *reinterpret_cast<const Vec<T, N>*>(p + i);
#pragma unroll
    for (int q = 0; q < N; ++q) x[q] = w.v[q];
    return;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) x[q] = i + q < n ? p[i + q] : fill;
}

// x into slots i .. i + N - 1 of p, those below n.
template <class T, int N>
__device__ __forceinline__ void store(T* p, int64_t i, int64_t n, bool vec,
                                      const T (&x)[N]) {
  if (vec && i + N <= n) {
    Vec<T, N> w;
#pragma unroll
    for (int q = 0; q < N; ++q) w.v[q] = x[q];
    *reinterpret_cast<Vec<T, N>*>(p + i) = w;
    return;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (i + q < n) p[i + q] = x[q];
  }
}

// status: [0] the tile counter, [1, 1 + T) the tiles' status words,
// [1 + T, 1 + 2T) their aggregates, [1 + 2T, 1 + 3T) their inclusive sums.
__device__ __forceinline__ void publish(uint64_t* status, int64_t T,
                                        int64_t tile, uint64_t what,
                                        uint64_t v) {
  *(volatile uint64_t*)(status + 1 + (int64_t)what * T + tile) = v;
  __threadfence();
  *(volatile uint64_t*)(status + 1 + tile) = what;
}

// The sum of the run open at the end of tile p, read back from the tiles
// before: the whole warp, tiles p - lane, 32 a step, to the nearest one
// whose inclusive sum is out.  Tile 0 always holds a run start (slot 0
// begins a row), so the walk ends there at the latest.
__device__ uint64_t look_back(const uint64_t* status, int64_t T, int64_t p,
                              int lane) {
  uint64_t carry = 0;
  while (true) {
    const int64_t q = p - lane;
    uint64_t what = kInclusive, v = 0;
    if (q >= 0) {
      const volatile uint64_t* w = status + 1 + q;
      while ((what = *w) == 0) {
      }
      __threadfence();
      v = *(const volatile uint64_t*)(status + 1 + (int64_t)what * T + q);
    }
    const unsigned incl = __ballot_sync(kFull, what == kInclusive);
    const int last = incl ? __ffs(incl) - 1 : 31;
    uint64_t x = lane <= last ? v : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    carry += x;
    if (incl) return carry;
    p -= 32;
  }
}

// One tile of the flat (R * C,) store.  counts: the counts in counted
// mode, nullptr in implicit mode; out: the totals (== counts in counted
// mode: in place).
template <class Key, class Cnt, bool kCounted>
__global__ void __launch_bounds__(kBlock)
rle_rows(const Key* __restrict__ keys, const Cnt* counts, Cnt* out,
         int64_t n, int64_t C, bool vec, uint64_t* __restrict__ status) {
  constexpr int V = 16 / sizeof(Key);  // slots a lane a round
  constexpr int kRounds = kItems / V;
  constexpr Key kSent = Sentinel<Key>::value;
  __shared__ int64_t s_tile;
  __shared__ Run s_warp[kWarps];
  __shared__ uint64_t s_carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = (int64_t)atomicAdd((unsigned long long*)status, 1ull);
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t T = (n + kTile - 1) / kTile;
  const int64_t base = tile * kTile + warp * kWarpSpan;

  Key k[kRounds][V];
  Cnt c[kRounds][V];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)(r * 32 + lane) * V;
    load<Key, V>(keys, i, n, vec, k[r], kSent);
    if constexpr (kCounted) load<Cnt, V>(counts, i, n, vec, c[r], (Cnt)0);
  }
  // the slot before the warp's span and the one after it
  Key before = kSent, after = kSent;
  if (lane == 0 && base > 0 && base <= n) before = keys[base - 1];
  if (lane == 31 && base + kWarpSpan < n) after = keys[base + kWarpSpan];

  // the lane's place in its row, round by round
  int64_t pos = (base + (int64_t)lane * V) % C;
  const int64_t step = (int64_t)(32 * V) % C;
  uint32_t starts = 0, ends = 0;  // bit r * V + v: a run starts / ends
  Run cin[kRounds];  // the runs from the warp's span start to the lane's
  Run w = {false, 0};  // the warp's rounds so far
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    // the slots beside the lane's: lanes l - 1 and l + 1, or the rounds
    // before and after, or the spans of the warps before and after
    Key prev = __shfl_up_sync(kFull, k[r][V - 1], 1);
    Key prev_round = before;
    if (r > 0) prev_round = __shfl_sync(kFull, k[r - 1][V - 1], 31);
    if (lane == 0) prev = prev_round;
    Key next = __shfl_down_sync(kFull, k[r][0], 1);
    Key next_round = after;
    if (r + 1 < kRounds) next_round = __shfl_sync(kFull, k[r + 1][0], 0);
    if (lane == 31) next = next_round;
    bool row_start[V + 1];
    int64_t q = pos;
#pragma unroll
    for (int v = 0; v <= V; ++v) {
      row_start[v] = q == 0;
      q = q + 1 == C ? 0 : q + 1;
    }
    Run loc = {false, 0};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const Key x = k[r][v];
      const bool st = row_start[v] || x != (v ? k[r][v - 1] : prev);
      const bool en = row_start[v + 1] || x != (v + 1 < V ? k[r][v + 1]
                                                          : next);
      starts |= (uint32_t)st << (r * V + v);
      ends |= (uint32_t)(en && x != kSent) << (r * V + v);
      uint64_t y = 1;
      if constexpr (kCounted) y = (uint64_t)(int64_t)c[r][v];
      loc = st ? Run{true, y} : Run{loc.f, loc.s + y};
    }
    Run inc = loc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run o = shfl_up(inc, d);
      if (lane >= d) inc = combine(o, inc);
    }
    Run ex = shfl_up(inc, 1);
    if (lane == 0) ex = {false, 0};
    cin[r] = combine(w, ex);
    w = combine(w, Run{__shfl_sync(kFull, (int)inc.f, 31) != 0,
                       __shfl_sync(kFull, inc.s, 31)});
    pos += step;
    if (pos >= C) pos -= C;
  }

  if (lane == 0) s_warp[warp] = w;
  __syncthreads();
  Run head = {false, 0};  // the tile's warps before this one
  for (int i = 0; i < warp; ++i) head = combine(head, s_warp[i]);
  if (warp == 0) {
    Run t = {false, 0};
    for (int i = 0; i < kWarps; ++i) t = combine(t, s_warp[i]);
    const bool first_starts = __shfl_sync(kFull, (int)(starts & 1u), 0);
    if (lane == 0) publish(status, T, tile, t.f ? kInclusive : kAggregate,
                           t.s);
    uint64_t carry = 0;
    if (!first_starts) carry = look_back(status, T, tile - 1, lane);
    if (lane == 0) {
      if (!t.f) publish(status, T, tile, kInclusive, carry + t.s);
      s_carry = carry;
    }
  }
  __syncthreads();
  head = combine(Run{false, s_carry}, head);

#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    uint64_t run = combine(head, cin[r]).s;
    Cnt o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint64_t y = 1;
      if constexpr (kCounted) y = (uint64_t)(int64_t)c[r][v];
      run = (starts >> (r * V + v) & 1u) ? y : run + y;
      o[v] = (ends >> (r * V + v) & 1u) ? (Cnt)run : (Cnt)0;
    }
    store<Cnt, V>(out, base + (int64_t)(r * 32 + lane) * V, n, vec, o);
  }
}

int64_t tiles(int64_t n) { return (n + kTile - 1) / kTile; }

template <class Key, class Cnt, bool kCounted>
int launch(const void* keys, const void* counts, void* out, int64_t n,
           int64_t C, uint64_t* status, cudaStream_t s) {
  constexpr uintptr_t cnt_chunk =
      (16 / sizeof(Key)) * sizeof(Cnt) < 16 ? (16 / sizeof(Key)) * sizeof(Cnt)
                                            : 16;
  const bool vec = (uintptr_t)keys % 16 == 0 &&
                   (uintptr_t)counts % cnt_chunk == 0 &&
                   (uintptr_t)out % cnt_chunk == 0;
  const int64_t T = tiles(n);
  cudaError_t e = cudaMemsetAsync(status, 0, (1 + 3 * T) * sizeof(uint64_t),
                                  s);
  if (e != cudaSuccess) return (int)e;
  rle_rows<Key, Cnt, kCounted><<<(unsigned)T, kBlock, 0, s>>>(
      static_cast<const Key*>(keys), static_cast<const Cnt*>(counts),
      static_cast<Cnt*>(out), n, C, vec, status);
  return (int)cudaGetLastError();
}

template <class Key>
int launch_key(const void* keys, const void* counts, void* out, int64_t n,
               int64_t C, int count_bytes, uint64_t* status,
               cudaStream_t s) {
  if (count_bytes == 4) {
    return counts ? launch<Key, int32_t, true>(keys, counts, out, n, C,
                                               status, s)
                  : launch<Key, int32_t, false>(keys, counts, out, n, C,
                                                status, s);
  }
  return counts ? launch<Key, int64_t, true>(keys, counts, out, n, C, status,
                                             s)
                : launch<Key, int64_t, false>(keys, counts, out, n, C,
                                              status, s);
}

}  // namespace

// Slots of a tile, and the status words a launch over n slots needs.
extern "C" int64_t fk_rle_rows_tile() { return kTile; }

extern "C" int64_t fk_rle_rows_status_words(int64_t n) {
  return 1 + 3 * tiles(n);
}

// The run totals of the R sorted rows of C slots of keys (key_bytes 4 or
// 8: int32 or int64) into out (count_bytes 4 or 8).  counts: nullptr for
// an implicit count of 1 a slot, else the counts (out may be counts: in
// place).  status: fk_rle_rows_status_words(R * C) uint64 words, zeroed
// here on the stream.
extern "C" int fk_rle_rows(const void* keys, const void* counts, void* out,
                           int64_t R, int64_t C, int key_bytes,
                           int count_bytes, void* status, void* stream) {
  if (R < 0 || C < 0 || (key_bytes != 4 && key_bytes != 8) ||
      (count_bytes != 4 && count_bytes != 8) ||
      (R * C > 0 && tiles(R * C) > 0x7fffffffll)) {
    return (int)cudaErrorInvalidValue;
  }
  if (R * C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  uint64_t* st = static_cast<uint64_t*>(status);
  return key_bytes == 4
             ? launch_key<int32_t>(keys, counts, out, R * C, C, count_bytes,
                                   st, s)
             : launch_key<int64_t>(keys, counts, out, R * C, C, count_bytes,
                                   st, s);
}
