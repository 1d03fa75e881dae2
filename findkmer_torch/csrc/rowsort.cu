// K3 on Hopper: sort every row of a (G, C) key matrix ascending, in place,
// carrying an optional payload (the counts) with each key.
//
// Replaces bench/probe_plsort.py::make_sorter.run / sort_kernel, the Pallas
// bitonic row sorter of the TPU package, which is the row-wise sort of the
// sparse store's compaction (findkmer_tpu/ops/compaction.py,
// findkmer_tpu/ops/sparse.py compact_*_2d / squeeze_2d).  The TPU kernel
// swaps bitonic partners with two pltpu.roll's per stage because Mosaic has
// no gather; a GPU thread can hold its slots in registers and reach a
// partner's with a warp shuffle.
//
// The network is the direction-free bitonic sort: merge size s runs one
// "flip" stage (slot i against i ^ (s - 1), its mirror in the s-block) and
// then half-cleaner stages (i against i ^ j for j = s/4 .. 1), and every
// compare-exchange puts the smaller key at the lower slot, swapping only
// when the upper key is strictly smaller.  Slots at or past C are loaded as
// the key type's maximum: such a slot is always the upper one of its pair
// and never strictly smaller, so it never moves, and it is not stored back.
// Rows of any length sort in place with no padding in memory, and a real
// key equal to the type's maximum stays a real key with its own payload
// (beside a payload such a slot is loaded as the largest pair: see below).
// Keys are compared as signed integers.  Ties land in any order, as the
// unstable sorts of the JAX package allow.
//
// Bound: bytes.  A row is read once and written once: 16 B a slot for
// int64 keys, 24 B with int32 counts, 8 B for int32 keys, over 3.35 TB/s;
// the network's log2(P) (log2(P) + 1) / 2 stages of P/2 compare-exchanges
// (P = next_pow2(C)) must fit under that.  The first version of this
// kernel kept the row in shared memory and ran every stage there with a
// __syncthreads() after each (55 stages at P = 1024, 66 at 2048), reading
// and writing both keys of every pair, 64-bit keys two-way bank-conflicted
// at small strides, the counts as a second array through all stages.  It
// reached 7-10% of the bound.  What this version does about each:
//
//   * A thread holds kE = 8 slots in registers, the payload beside the key
//     and swapped under the same predicate.  The "home" layout gives thread
//     (warp w, lane l) the 16-byte chunks q of its warp's 256-slot span:
//     slot = 256 w + 32 V q + V l + v, with V = 16 B / sizeof(key) slots a
//     chunk (v < V, q < 8 / V).  So global loads and stores are 16 B a
//     thread with neighbouring lanes on neighbouring addresses, and the
//     slot-index bits split into register bits (v and q: a stride there is
//     a compare-exchange between two registers of one thread), lane bits
//     (5 bits above v: one __shfl_xor_sync per 32-bit word) and, above
//     bit 8, warp bits.  Every stage of every merge size up to 256 and the
//     strides 128 .. 1 of the larger ones run with no shared memory and no
//     barrier.
//   * The stages that cross warps (the flip and the strides >= 256 of merge
//     sizes >= 512: 3 of 55 stages at P = 1024, 6 of 66 at 2048) run in a
//     "column" layout whose register bits are the top bits of the merge
//     size, so they too are compare-exchanges between registers.  The flip
//     pairs slot i with i ^ (s - 1), which flips the low bits as well: the
//     registers of the upper half hold their thread's low bits mirrored, so
//     the pair still sits in one thread.  Changing layout is a transpose
//     through shared memory: every thread writes its slots, one barrier,
//     every thread reads its new slots.  A thread only ever writes the
//     slots it read last, so one barrier per transpose is enough: two per
//     merge size >= 512 (4 in all at P = 1024, 6 at 2048) instead of one
//     per stage.  Column reads and writes touch consecutive slots in
//     consecutive threads and home ones 16 B a thread, so neither
//     bank-conflicts and nothing is padded.
//   * Launch geometry: a row of P <= 256 slots is one warp's, four rows to a
//     block of 128 threads, no shared memory at all.  Larger rows take
//     P / 8 threads (128 for P = 1024, 256 for 2048) and P * (key + payload)
//     bytes of shared memory (8 KB and 24 KB at the production shapes).
//     The stages are chains of dependent shuffles, so it is resident warps
//     that hide their latency: __launch_bounds__ asks for 768 threads an
//     SM (6 blocks at P = 1024, 3 at 2048), which caps a thread at 80
//     registers; the production instantiations use 40 to 80 without
//     spilling (`nvcc -Xptxas -v`).
//   * A lane exchange costs each side one shuffle per 32-bit word and its
//     half of the compare: the lower side keeps the minimum and the upper
//     side the maximum, one comparison either way.  The two sides must
//     agree on a tie.  Without a payload a tie needs no agreement.  With
//     one, the comparison is of the whole (key, payload) pair, so that only
//     identical pairs tie; slots past the row end carry the largest
//     payload beside the largest key and so remain the largest pair.  The
//     integer pipe (compares and selects), not the shuffles or the memory,
//     is what the kernel fills, so a cheaper exchange is time saved: the
//     raw rows halved against comparing "upper < lower" in both roles.
//   * Rows longer than a tile of 4096 slots (dedup_rows' single row, a
//     raised --sparse-capacity) keep the scheme of the first version: the
//     tiles sort first; then for each merge size s > tile the strides >=
//     tile run as global-memory compare-exchange passes, one launch per
//     (s, stride), and the tile kernel finishes the strides < tile of every
//     tile (its MERGE form: column phases without a flip, then home).
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// Every launch goes on the caller's stream; nothing is allocated and nothing
// synchronises.  The return value is the first launch error, or
// cudaGetLastError() after the last launch.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

struct NoVal {};

constexpr int kLogE = 3;
constexpr int kE = 1 << kLogE;            // slots a thread holds
constexpr int kLogWarp = 5 + kLogE;       // log2 of the slots a warp holds
constexpr int kMaxLogTile = 12;           // 4096 slots, 512 threads
constexpr int kSmallWarps = 4;            // rows a block of sort_small takes
constexpr int kPassThreads = 256;
constexpr int kPassBlocksPerSm = 32;
constexpr int64_t kMaxGrid = 0x7FFFFFFF;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

template <typename V>
constexpr bool kHasVal = !std::is_same<V, NoVal>::value;

// log2 of the slots in a 16-byte chunk of keys
template <typename K>
constexpr int kLogV = sizeof(K) == 8 ? 1 : 2;

template <typename K>
__device__ __forceinline__ K key_max() {
  if constexpr (sizeof(K) == 8) {
    return (K)INT64_MAX;
  } else {
    return (K)INT32_MAX;
  }
}

// V slots of keys or payload, moved as one access where the row allows it
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Chunk {
  T x[N];
};

// ---- the home layout -------------------------------------------------------

// Register and lane bits that a flip of merge size 2^L (L <= kLogWarp)
// changes, and those of the single stride 2^B (B < kLogWarp); LV = kLogV.
__host__ __device__ constexpr int flip_rmask(int L, int LV) {
  const int vb = L < LV ? L : LV;
  const int qb = L > LV + 5 ? L - LV - 5 : 0;
  return ((1 << vb) - 1) | (((1 << qb) - 1) << LV);
}
__host__ __device__ constexpr int flip_lmask(int L, int LV) {
  const int lb = L <= LV ? 0 : (L - LV > 5 ? 5 : L - LV);
  return (1 << lb) - 1;
}
__host__ __device__ constexpr int stride_rmask(int B, int LV) {
  return B < LV ? 1 << B : (B >= LV + 5 ? 1 << (B - 5) : 0);
}
__host__ __device__ constexpr int stride_lmask(int B, int LV) {
  return (B >= LV && B < LV + 5) ? 1 << (B - LV) : 0;
}

// Compare-exchange of two registers of one thread: the smaller key to `lo`.
template <typename K, typename V>
__device__ __forceinline__ void cx(K& lo, K& hi, V& vlo, V& vhi) {
  const bool swap = hi < lo;
  const K a = lo;
  lo = swap ? hi : a;
  hi = swap ? a : hi;
  if constexpr (kHasVal<V>) {
    const V va = vlo;
    vlo = swap ? vhi : va;
    vhi = swap ? va : vhi;
  }
}

// Whether the pair (ak, av) sorts before (bk, bv): by key as signed
// integers, then by payload as unsigned ones.  Written so that a 64-bit key
// with a 32-bit payload costs one 32-bit and one 64-bit comparison.
template <typename K, typename V>
__device__ __forceinline__ bool pair_less(K ak, V av, K bk, V bv) {
  if constexpr (sizeof(K) == 8 && sizeof(V) == 4) {
    const int32_t ah = (int32_t)(ak >> 32);
    const int32_t bh = (int32_t)(bk >> 32);
    const uint64_t aw = ((uint64_t)(uint32_t)ak << 32) | (uint32_t)av;
    const uint64_t bw = ((uint64_t)(uint32_t)bk << 32) | (uint32_t)bv;
    return ah < bh || (ah == bh && aw < bw);
  } else if constexpr (sizeof(K) == 4 && sizeof(V) == 4) {
    return (((int64_t)ak << 32) | (uint32_t)av) <
           (((int64_t)bk << 32) | (uint32_t)bv);
  } else {
    return ak < bk || (ak == bk && (uint64_t)av < (uint64_t)bv);
  }
}

// This thread's half of a compare-exchange with another lane: `lower` says
// whether this thread holds the lower slot of the pair.  The lower side
// keeps the minimum and the upper side the maximum, one comparison either
// way.  Both sides must agree on a tie or a payload would be kept twice:
// with a payload the comparison is of the whole (key, payload) pair, under
// which only identical pairs tie, and then either choice leaves the same
// values.  (A comparison of the keys alone would need "upper < lower"
// evaluated in both roles: twice the comparisons and a select by role.)
template <typename K, typename V>
__device__ __forceinline__ void take(K& own, V& vown, K other, V vother,
                                     bool lower) {
  if constexpr (kHasVal<V>) {
    const bool swap = pair_less(own, vown, other, vother) != lower;
    own = swap ? other : own;
    vown = swap ? vother : vown;
  } else {
    own = ((own < other) != lower) ? other : own;
  }
}

// One stage on slots held in the home layout.  The partner of register r
// of lane l is register r ^ RMASK of lane l ^ LMASK; TOP is the slot-index
// bit in which the pair's lower slot has a 0.
template <typename K, typename V, int RMASK, int LMASK, int TOP>
__device__ __forceinline__ void home_stage(K (&k)[kE], V (&v)[kE], int lane) {
  constexpr int LV = kLogV<K>;
  constexpr bool top_in_lane = TOP >= LV && TOP < LV + 5;
  constexpr int top_reg =
      TOP < LV ? 1 << TOP : (TOP >= LV + 5 ? 1 << (TOP - 5) : 0);
  if constexpr (LMASK == 0) {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      if ((r ^ RMASK) > r) cx(k[r], k[r ^ RMASK], v[r], v[r ^ RMASK]);
    }
  } else {
    bool lane_lower = false;
    if constexpr (top_in_lane) lane_lower = !(lane & (1 << (TOP - LV)));
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int p = r ^ RMASK;
      if (p < r) continue;
      // both registers leave before either is overwritten
      const K from_p = __shfl_xor_sync(kFullMask, k[p], LMASK);
      V vfrom_p = v[p];
      if constexpr (kHasVal<V>) {
        vfrom_p = __shfl_xor_sync(kFullMask, v[p], LMASK);
      }
      if constexpr (RMASK != 0) {
        const K from_r = __shfl_xor_sync(kFullMask, k[r], LMASK);
        V vfrom_r = v[r];
        if constexpr (kHasVal<V>) {
          vfrom_r = __shfl_xor_sync(kFullMask, v[r], LMASK);
        }
        take(k[p], v[p], from_r, vfrom_r,
             top_in_lane ? lane_lower : !(p & top_reg));
      }
      take(k[r], v[r], from_p, vfrom_p,
           top_in_lane ? lane_lower : !(r & top_reg));
    }
  }
}

// Half-cleaner strides 2^B .. 1 in the home layout (B < kLogWarp).
template <typename K, typename V, int B>
__device__ __forceinline__ void home_strides(K (&k)[kE], V (&v)[kE],
                                             int lane) {
  if constexpr (B >= 0) {
    constexpr int LV = kLogV<K>;
    home_stage<K, V, stride_rmask(B, LV), stride_lmask(B, LV), B>(k, v, lane);
    home_strides<K, V, B - 1>(k, v, lane);
  }
}

// Merge sizes 2^L .. 2^kLogWarp, whole, in the home layout.
template <typename K, typename V, int L>
__device__ __forceinline__ void home_merges(K (&k)[kE], V (&v)[kE],
                                            int lane) {
  if constexpr (L <= kLogWarp) {
    constexpr int LV = kLogV<K>;
    home_stage<K, V, flip_rmask(L, LV), flip_lmask(L, LV), L - 1>(k, v, lane);
    home_strides<K, V, L - 2>(k, v, lane);
    home_merges<K, V, L + 1>(k, v, lane);
  }
}

// ---- layouts as types: which slot register r of thread t holds ------------

template <typename K>
struct Home {
  static __device__ __forceinline__ int slot(int t, int r) {
    constexpr int LV = kLogV<K>;
    return ((t >> 5) << kLogWarp) | ((r >> LV) << (5 + LV)) |
           ((t & 31) << LV) | (r & ((1 << LV) - 1));
  }
};

// Register bits are the slot bits LB .. LB + kLogE - 1; the thread index
// supplies the bits below and above.  MIRROR: the registers whose top bit
// is set hold the thread's low bits inverted, which puts slot i and
// i ^ (2^(LB + kLogE) - 1) in one thread.
template <int LB, bool MIRROR>
struct Col {
  static __device__ __forceinline__ int slot(int t, int r) {
    constexpr int low_mask = (1 << LB) - 1;
    int low = t & low_mask;
    if (MIRROR && (r >> (kLogE - 1))) low = ~low & low_mask;
    return ((t >> LB) << (LB + kLogE)) | (r << LB) | low;
  }
};

// The transpose between two layouts through the shared tile: one barrier.
// Each thread writes the slots it holds, which are the slots it read last.
template <typename K, typename V, typename From, typename To>
__device__ __forceinline__ void transpose(K (&k)[kE], V (&v)[kE], K* sk,
                                          V* sv, int t) {
  if constexpr (std::is_same<From, To>::value) return;
  constexpr int NV = 1 << kLogV<K>;
  if constexpr (std::is_same<From, Home<K>>::value) {
#pragma unroll
    for (int q = 0; q < kE / NV; ++q) {
      const int c = Home<K>::slot(t, q * NV) / NV;
      Chunk<K, NV> ck;
#pragma unroll
      for (int j = 0; j < NV; ++j) ck.x[j] = k[q * NV + j];
      reinterpret_cast<Chunk<K, NV>*>(sk)[c] = ck;
      if constexpr (kHasVal<V>) {
        Chunk<V, NV> cv;
#pragma unroll
        for (int j = 0; j < NV; ++j) cv.x[j] = v[q * NV + j];
        reinterpret_cast<Chunk<V, NV>*>(sv)[c] = cv;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int i = From::slot(t, r);
      sk[i] = k[r];
      if constexpr (kHasVal<V>) sv[i] = v[r];
    }
  }
  __syncthreads();
  if constexpr (std::is_same<To, Home<K>>::value) {
#pragma unroll
    for (int q = 0; q < kE / NV; ++q) {
      const int c = Home<K>::slot(t, q * NV) / NV;
      const Chunk<K, NV> ck = reinterpret_cast<const Chunk<K, NV>*>(sk)[c];
#pragma unroll
      for (int j = 0; j < NV; ++j) k[q * NV + j] = ck.x[j];
      if constexpr (kHasVal<V>) {
        const Chunk<V, NV> cv = reinterpret_cast<const Chunk<V, NV>*>(sv)[c];
#pragma unroll
        for (int j = 0; j < NV; ++j) v[q * NV + j] = cv.x[j];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const int i = To::slot(t, r);
      k[r] = sk[i];
      if constexpr (kHasVal<V>) v[r] = sv[i];
    }
  }
}

// Strides 2^B .. 2^LO on slots held in Col<LB, *>: register bit B - LB.
template <typename K, typename V, int LB, int B, int LO>
__device__ __forceinline__ void col_strides(K (&k)[kE], V (&v)[kE]) {
  if constexpr (B >= LO) {
    constexpr int bit = 1 << (B - LB);
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      if (!(r & bit)) cx(k[r], k[r | bit], v[r], v[r | bit]);
    }
    col_strides<K, V, LB, B - 1, LO>(k, v);
  }
}

__host__ __device__ constexpr int imax(int a, int b) {
  return a > b ? a : b;
}

// The strides 2^B .. 2^kLogWarp, which cross warps, on slots held in layout
// From: column phases of up to kLogE strides each, then the transpose home.
template <typename K, typename V, typename From, int B>
__device__ __forceinline__ void wide_strides(K (&k)[kE], V (&v)[kE], K* sk,
                                             V* sv, int t) {
  if constexpr (B < kLogWarp) {
    transpose<K, V, From, Home<K>>(k, v, sk, sv, t);
  } else {
    constexpr int LB = B - kLogE + 1;
    constexpr int LO = imax(LB, kLogWarp);
    using To = Col<LB, false>;
    transpose<K, V, From, To>(k, v, sk, sv, t);
    col_strides<K, V, LB, B, LO>(k, v);
    wide_strides<K, V, To, LO - 1>(k, v, sk, sv, t);
  }
}

// Merge sizes 2^L .. 2^LOGT (L > kLogWarp), from and to the home layout.
template <typename K, typename V, int L, int LOGT>
__device__ __forceinline__ void wide_merges(K (&k)[kE], V (&v)[kE], K* sk,
                                            V* sv, int t) {
  if constexpr (L <= LOGT) {
    constexpr int LB = L - kLogE;  // register bits LB .. L - 1
    constexpr int LO = imax(LB, kLogWarp);
    using X = Col<LB, true>;
    transpose<K, V, Home<K>, X>(k, v, sk, sv, t);
#pragma unroll
    for (int r = 0; r < kE / 2; ++r) {  // the flip: r against all bits flipped
      cx(k[r], k[r ^ (kE - 1)], v[r], v[r ^ (kE - 1)]);
    }
    col_strides<K, V, LB, L - 2, LO>(k, v);
    wide_strides<K, V, X, LO - 1>(k, v, sk, sv, t);
    home_strides<K, V, kLogWarp - 1>(k, v, t & 31);
    wide_merges<K, V, L + 1, LOGT>(k, v, sk, sv, t);
  }
}

// ---- global memory <-> registers, home layout ------------------------------

// n: the real slots of this thread's row or tile, which starts at rk / rv.
// vec: the row starts are 16-byte aligned (payload chunks to their size).
template <typename K, typename V>
__device__ __forceinline__ void load_home(K (&k)[kE], V (&v)[kE],
                                          const K* rk, const V* rv, int n,
                                          int t, bool vec) {
  constexpr int NV = 1 << kLogV<K>;
#pragma unroll
  for (int q = 0; q < kE / NV; ++q) {
    const int i0 = Home<K>::slot(t, q * NV);
    if (vec && i0 + NV <= n) {
      const Chunk<K, NV> ck = reinterpret_cast<const Chunk<K, NV>*>(rk)[i0 / NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) k[q * NV + j] = ck.x[j];
      if constexpr (kHasVal<V>) {
        const Chunk<V, NV> cv =
            reinterpret_cast<const Chunk<V, NV>*>(rv)[i0 / NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) v[q * NV + j] = cv.x[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const bool real = i0 + j < n;
        k[q * NV + j] = real ? rk[i0 + j] : key_max<K>();
        if constexpr (kHasVal<V>) v[q * NV + j] = real ? rv[i0 + j] : V(-1);
      }
    }
  }
}

template <typename K, typename V>
__device__ __forceinline__ void store_home(const K (&k)[kE], const V (&v)[kE],
                                           K* rk, V* rv, int n, int t,
                                           bool vec) {
  constexpr int NV = 1 << kLogV<K>;
#pragma unroll
  for (int q = 0; q < kE / NV; ++q) {
    const int i0 = Home<K>::slot(t, q * NV);
    if (vec && i0 + NV <= n) {
      Chunk<K, NV> ck;
#pragma unroll
      for (int j = 0; j < NV; ++j) ck.x[j] = k[q * NV + j];
      reinterpret_cast<Chunk<K, NV>*>(rk)[i0 / NV] = ck;
      if constexpr (kHasVal<V>) {
        Chunk<V, NV> cv;
#pragma unroll
        for (int j = 0; j < NV; ++j) cv.x[j] = v[q * NV + j];
        reinterpret_cast<Chunk<V, NV>*>(rv)[i0 / NV] = cv;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (i0 + j < n) {
          rk[i0 + j] = k[q * NV + j];
          if constexpr (kHasVal<V>) rv[i0 + j] = v[q * NV + j];
        }
      }
    }
  }
}

// ---- kernels ---------------------------------------------------------------

// Rows of at most 2^kLogWarp slots: one warp a row, registers and shuffles
// only.
template <typename K, typename V>
__global__ void __launch_bounds__(32 * kSmallWarps)
sort_small(K* __restrict__ keys, V* __restrict__ vals, int64_t G, int64_t C,
           int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t first = (int64_t)blockIdx.x * kSmallWarps + (threadIdx.x >> 5);
  const int64_t step = (int64_t)gridDim.x * kSmallWarps;
  for (int64_t row = first; row < G; row += step) {
    K* rk = keys + row * C;
    V* rv = nullptr;
    if constexpr (kHasVal<V>) rv = vals + row * C;
    K k[kE];
    V v[kE];
    load_home<K, V>(k, v, rk, rv, (int)C, lane, vec != 0);
    home_merges<K, V, 1>(k, v, lane);
    store_home<K, V>(k, v, rk, rv, (int)C, lane, vec != 0);
  }
}

// Blocks an SM should hold at once: enough for 768 threads, which caps the
// registers a thread may use at 80.
__host__ __device__ constexpr int tile_min_blocks(int LOGT) {
  return imax(1, 768 >> (LOGT - kLogE));
}

// Block b of the grid-stride loop takes tile b % tiles_per_row, of 2^LOGT
// slots, of row b / tiles_per_row.  MERGE false: the whole network up to
// the tile's size.  MERGE true: only the half-cleaner strides tile/2 .. 1
// (the larger strides of the current merge size ran as global passes).
template <typename K, typename V, int LOGT, bool MERGE>
__global__ void __launch_bounds__(1 << (LOGT - kLogE),
                                  tile_min_blocks(LOGT))
sort_tiles(K* __restrict__ keys, V* __restrict__ vals, int64_t G, int64_t C,
           int64_t tiles_per_row, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int tile = 1 << LOGT;
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + (size_t)tile * sizeof(K));
  const int t = threadIdx.x;
  const int64_t n_tiles = G * tiles_per_row;
  for (int64_t b = blockIdx.x; b < n_tiles; b += gridDim.x) {
    const int64_t row = b / tiles_per_row;
    const int64_t t0 = (b - row * tiles_per_row) * tile;
    const int64_t left = C - t0;
    const int n = (int)(left < tile ? left : tile);  // real slots, >= 1
    K* rk = keys + row * C + t0;
    V* rv = nullptr;
    if constexpr (kHasVal<V>) rv = vals + row * C + t0;
    K k[kE];
    V v[kE];
    load_home<K, V>(k, v, rk, rv, n, t, vec != 0);
    if constexpr (MERGE) {
      wide_strides<K, V, Home<K>, LOGT - 1>(k, v, sk, sv, t);
      home_strides<K, V, kLogWarp - 1>(k, v, t & 31);
    } else {
      home_merges<K, V, 1>(k, v, t & 31);
      wide_merges<K, V, kLogWarp + 1, LOGT>(k, v, sk, sv, t);
    }
    store_home<K, V>(k, v, rk, rv, n, t, vec != 0);
  }
}

template <typename K, typename V>
__device__ __forceinline__ void cmp_swap(K* k, V* v, int64_t i, int64_t p) {
  const K a = k[i];
  const K b = k[p];
  if (b < a) {
    k[i] = b;
    k[p] = a;
    if constexpr (kHasVal<V>) {
      const V t = v[i];
      v[i] = v[p];
      v[p] = t;
    }
  }
}

// One global stage over every row: stride j of merge size `size` (flip
// stage when flip != 0).  Pair t of a row is thread index t of that row's
// P/2 pairs; pairs reaching past C are skipped.
template <typename K, typename V>
__global__ void __launch_bounds__(kPassThreads)
sort_pass(K* __restrict__ keys, V* __restrict__ vals, int64_t G, int64_t C,
          int log_half_p, int64_t size, int64_t j, int flip) {
  const int64_t half_p = (int64_t)1 << log_half_p;
  const int64_t total = G * half_p;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t row = idx >> log_half_p;
    const int64_t t = idx & (half_p - 1);
    int64_t i;
    int64_t p;
    if (flip) {
      const int64_t h = size >> 1;
      const int64_t base = (t / h) * size;
      const int64_t off = t & (h - 1);
      i = base + off;
      p = base + size - 1 - off;
    } else {
      i = 2 * t - (t & (j - 1));
      p = i + j;
    }
    if (p < C) {
      V* rv = nullptr;
      if constexpr (kHasVal<V>) rv = vals + row * C;
      cmp_swap(keys + row * C, rv, i, p);
    }
  }
}

// ---- launches --------------------------------------------------------------

template <typename K, typename V, int LOGT, bool MERGE>
cudaError_t launch_tiles(K* keys, V* vals, int64_t G, int64_t C, int vec,
                         cudaStream_t s) {
  constexpr int tile = 1 << LOGT;
  constexpr size_t smem =
      (size_t)tile * (sizeof(K) + (kHasVal<V> ? sizeof(V) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_tiles<K, V, LOGT, MERGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles_per_row = (C + tile - 1) / tile;
  const int64_t n_tiles = G * tiles_per_row;
  const int grid = (int)(n_tiles < kMaxGrid ? n_tiles : kMaxGrid);
  constexpr int threads = 1 << (LOGT - kLogE);
  sort_tiles<K, V, LOGT, MERGE><<<grid, threads, smem, s>>>(
      keys, vals, G, C, tiles_per_row, vec);
  return cudaGetLastError();
}

template <typename K, typename V>
int run(void* keys_, void* vals_, int64_t G, int64_t C, cudaStream_t s) {
  K* keys = static_cast<K*>(keys_);
  V* vals = static_cast<V*>(vals_);
  // 16-byte accesses need every row to start on a 16-byte boundary (and
  // the payload's chunks on one of their own size)
  constexpr int NV = 1 << kLogV<K>;
  constexpr size_t val_chunk =
      kHasVal<V> ? (sizeof(V) * NV < 16 ? sizeof(V) * NV : 16) : 1;
  const bool vec = C % NV == 0 && (uintptr_t)keys_ % 16 == 0 &&
                   (uintptr_t)vals_ % val_chunk == 0;
  int log_p = 0;
  while (((int64_t)1 << log_p) < C) ++log_p;

  if (log_p <= kLogWarp) {
    const int64_t blocks = (G + kSmallWarps - 1) / kSmallWarps;
    const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
    sort_small<K, V><<<grid, 32 * kSmallWarps, 0, s>>>(keys, vals, G, C, vec);
    return (int)cudaGetLastError();
  }
  switch (log_p) {
    case 9:
      return (int)launch_tiles<K, V, 9, false>(keys, vals, G, C, vec, s);
    case 10:
      return (int)launch_tiles<K, V, 10, false>(keys, vals, G, C, vec, s);
    case 11:
      return (int)launch_tiles<K, V, 11, false>(keys, vals, G, C, vec, s);
    default:
      break;
  }
  cudaError_t err =
      launch_tiles<K, V, kMaxLogTile, false>(keys, vals, G, C, vec, s);
  if (err != cudaSuccess || log_p <= kMaxLogTile) return (int)err;

  int dev = 0;
  int sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t tile = (int64_t)1 << kMaxLogTile;
  const int64_t P = (int64_t)1 << log_p;
  const int log_half_p = log_p - 1;
  const int64_t pairs = G * (P >> 1);
  const int64_t need = (pairs + kPassThreads - 1) / kPassThreads;
  const int64_t cap = (int64_t)sms * kPassBlocksPerSm;
  const int pass_grid = (int)(need < cap ? need : cap);
  for (int64_t size = 2 * tile; size <= P; size <<= 1) {
    sort_pass<K, V><<<pass_grid, kPassThreads, 0, s>>>(
        keys, vals, G, C, log_half_p, size, size >> 1, 1);
    for (int64_t j = size >> 2; j >= tile; j >>= 1) {
      sort_pass<K, V><<<pass_grid, kPassThreads, 0, s>>>(
          keys, vals, G, C, log_half_p, size, j, 0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_tiles<K, V, kMaxLogTile, true>(keys, vals, G, C, vec, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename K>
int run_key(void* keys, void* vals, int64_t G, int64_t C, int val_bytes,
            cudaStream_t s) {
  switch (val_bytes) {
    case 0:
      return run<K, NoVal>(keys, nullptr, G, C, s);
    case 4:
      return run<K, int32_t>(keys, vals, G, C, s);
    case 8:
      return run<K, int64_t>(keys, vals, G, C, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Sort each of the G rows of keys (G x C, row-major, int32 or int64 by
// key_bytes) ascending in place; vals (same shape, int32 or int64 by
// val_bytes; NULL with val_bytes 0) move with their keys.
extern "C" int fk_sort_rows(void* keys, void* vals, int64_t G, int64_t C,
                            int key_bytes, int val_bytes, void* stream) {
  if (G < 0 || C < 0 || (key_bytes != 4 && key_bytes != 8) ||
      (val_bytes != 0 && val_bytes != 4 && val_bytes != 8) ||
      ((val_bytes == 0) != (vals == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (G == 0 || C < 2) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (key_bytes == 4) return run_key<int32_t>(keys, vals, G, C, val_bytes, s);
  return run_key<int64_t>(keys, vals, G, C, val_bytes, s);
}
