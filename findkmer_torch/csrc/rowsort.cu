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
// A row of up to a tile sorts in place with no padding in memory, and a real
// key equal to the type's maximum stays a real key with its own payload
// (beside a payload such a slot is loaded as the largest pair: see below).
// Keys are compared as signed integers.  Ties land in any order, as the
// unstable sorts of the JAX package allow.
//
// Bound: bytes.  A row of up to a tile is read once and written once: 16 B
// a slot for int64 keys, 24 B with int32 counts, 8 B for int32 keys, over
// 3.35 TB/s;
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
//     raised --sparse-capacity) are a merge sort, which reads and writes
//     the row once a pass: its bound is passes x 2 x the row's bytes /
//     3.35 TB/s (13 passes, 6.25 ms for the 805 MB of a 2^26-slot row of
//     int64 keys and int32 counts).  The first version ran the bitonic
//     network there, one global launch per (merge size, stride) and a tile
//     launch per merge size: 120 passes at 2^26.  Now:
//     - sort_spans sorts each span of 16384 slots (192 KB at 12 B a slot;
//       8192 at 16 B) in place inside shared memory, one block of 512 an
//       SM: asynchronous copies in, each thread sorts its 32 slots in
//       registers (the direction-free bitonic network, so the maximum
//       loaded past a row's end never moves), then nine merge levels in
//       shared memory, one barrier pair a level.  A level is bound by the
//       shared memory's bandwidth at about a third of a global pass
//       (`chip_smoke.py --only rowsort` times each kernel of a long row's
//       sort from a torch.profiler trace); sorting tiles of 512 .. 4096
//       with the network instead costs more than the whole stage.
//     - Merge passes merge each pair of neighbouring sorted runs of w =
//       16384, 32768, .. < C slots, merge path (Green, McColl and Bader
//       2012, as in moderngpu's mergesort): a block of 128 owns 1024
//       consecutive output slots (8 a thread), found on its pair's merge
//       path by a partition launch before the pass (a binary search along
//       the cross diagonal a block boundary).  The block takes its spans
//       in a grid-stride loop, six blocks an SM, the next span's A and B
//       slices loading into shared memory by asynchronous copies while it
//       merges the current one; each thread searches its own diagonal
//       there and merges its 8 slots serially in registers (the two head
//       keys in registers: one dependent shared load a step), and the
//       block writes its slice back through shared memory, skewed by one
//       slot every 8 so that the threads' runs hit distinct banks, in
//       16-byte stores where the rows allow.  The partition and the merge
//       share one tie rule, a first (a <= b takes a), so a run of equal
//       keys across a split is neither lost nor doubled.  Row ends and a
//       short last run are ordinary lengths: nothing past C is read.
//     - The passes ping-pong between the row and a scratch of its shape
//       given by the caller, with the splits; after an odd number of
//       passes one device-to-device copy of the scratch (cudaMemcpyAsync)
//       brings the rows home.
//
// Plain C interface, loaded with ctypes (findkmer_torch/ops/cuda/_build.py).
// Every launch goes on the caller's stream; nothing is allocated (the
// caller gives the scratch) and nothing synchronises.  The return value is the first launch error, or
// cudaGetLastError() after the last launch.

#include <cstdint>
#include <type_traits>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

struct NoVal {};

constexpr int kLogE = 3;
constexpr int kE = 1 << kLogE;            // slots a thread holds
constexpr int kLogWarp = 5 + kLogE;       // log2 of the slots a warp holds
constexpr int kMaxLogTile = 12;           // 4096 slots, 512 threads
constexpr int kSmallWarps = 4;            // rows a block of sort_small takes
constexpr int kSpanThreads = 512;         // a block of sort_spans, one an SM
constexpr int kMergeThreads = 128;        // a block of a merge pass
constexpr int kMergeVT = 8;               // output slots a thread merges
constexpr int kMergeSpan = kMergeThreads * kMergeVT;  // 1024
constexpr int kMergeBlocksPerSm = 6;      // 85 registers a thread at most
constexpr int kMergeStages = 2;           // spans a merge block holds
constexpr int kPartThreads = 256;
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
// slots, of row b / tiles_per_row, and runs the whole network up to the
// tile's size.
template <typename K, typename V, int LOGT>
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
    home_merges<K, V, 1>(k, v, t & 31);
    wide_merges<K, V, kLogWarp + 1, LOGT>(k, v, sk, sv, t);
    store_home<K, V>(k, v, rk, rv, n, t, vec != 0);
  }
}

// ---- rows longer than a tile: merge-path merges -----------------------------

// Bytes of a slot: its key and its payload.
template <typename K, typename V>
constexpr int kSlotBytes = (int)(sizeof(K) + (kHasVal<V> ? sizeof(V) : 0));

// The spans that sort_spans sorts inside shared memory: 16384 slots (192
// KB at 12 B a slot), 8192 at 16 B; each of its threads holds VT of them.
template <typename K, typename V>
constexpr int kSpanSlots = kSlotBytes<K, V> > 12 ? 8192 : 16384;

// Shared memory holds slot j at skew<VT>(j): one slot of padding every VT,
// so that the VT consecutive slots each thread writes back from its
// registers fall on distinct banks across a warp; a margin of 2 VT slots
// takes the reads past a run's end that a finished thread makes.
template <int VT>
__device__ __forceinline__ int skew(int j) {
  return j + j / VT;
}
__host__ __device__ constexpr int smem_slots(int span, int vt) {
  return span + span / vt + 2 * vt;
}

// Merge path: of the first d outputs of merging sorted a (na slots) and b
// (nb), how many come from a.  Ties take a first: a[i] goes before b[j]
// when a[i] <= b[j].  A binary search along the cross diagonal; in global
// memory here, in (skewed) shared memory in smem_path.
template <typename K>
__device__ __forceinline__ int64_t merge_path(const K* a, int64_t na,
                                              const K* b, int64_t nb,
                                              int64_t d) {
  int64_t lo = d > nb ? d - nb : 0;
  int64_t hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename K, int VT>
__device__ __forceinline__ int smem_path(const K* s, int a0, int na, int b0,
                                         int nb, int d) {
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[skew<VT>(a0 + mid)] <= s[skew<VT>(b0 + d - 1 - mid)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Outputs d .. d + VT - 1 of merging the shared slots [a0, a0 + na) and
// [b0, b0 + nb), a first on ties, into registers: this thread's diagonal,
// then VT serial steps.  The two head keys stay in registers, so a step
// waits on one shared load (the next key of the side it took); a payload
// load is off that chain.  Reads past a side's end land in the margin and
// are never taken.
template <typename K, typename V, int VT>
__device__ __forceinline__ void merge_serial(const K* sk, const V* sv, int a0,
                                             int na, int b0, int nb, int d,
                                             K (&k)[VT], V (&v)[VT]) {
  int i = smem_path<K, VT>(sk, a0, na, b0, nb, d);
  int j = d - i;
  K ka = sk[skew<VT>(a0 + i)];
  K kb = sk[skew<VT>(b0 + j)];
#pragma unroll
  for (int r = 0; r < VT; ++r) {
    const bool take_a = i < na && (j >= nb || ka <= kb);
    k[r] = take_a ? ka : kb;
    if constexpr (kHasVal<V>) v[r] = sv[skew<VT>(take_a ? a0 + i : b0 + j)];
    i += take_a;
    j += !take_a;
    const K next = sk[skew<VT>(take_a ? a0 + i : b0 + j)];
    ka = take_a ? next : ka;
    kb = take_a ? kb : next;
  }
}

// A thread's VT outputs, slots q0 .. of n, back into shared memory.
template <typename K, typename V, int VT>
__device__ __forceinline__ void to_smem(K* sk, V* sv, int q0, int n,
                                        const K (&k)[VT], const V (&v)[VT]) {
#pragma unroll
  for (int r = 0; r < VT; ++r) {
    if (q0 + r < n) {
      sk[skew<VT>(q0 + r)] = k[r];
      if constexpr (kHasVal<V>) sv[skew<VT>(q0 + r)] = v[r];
    }
  }
}

// n consecutive slots from skewed shared memory to global memory at (rk,
// rv), coalesced: 16-byte stores a thread where `vec` (the slots start on
// 16-byte boundaries, payload chunks on their size), else 1 slot.
template <typename K, typename V, int NT, int VT>
__device__ __forceinline__ void store_span(const K* sk, const V* sv, K* rk,
                                           V* rv, int n, int t, bool vec) {
  constexpr int NV = 1 << kLogV<K>;
  const int full = vec ? n / NV * NV : 0;
  for (int c = t * NV; c < full; c += NT * NV) {
    Chunk<K, NV> ck;
#pragma unroll
    for (int x = 0; x < NV; ++x) ck.x[x] = sk[skew<VT>(c + x)];
    reinterpret_cast<Chunk<K, NV>*>(rk)[c / NV] = ck;
    if constexpr (kHasVal<V>) {
      Chunk<V, NV> cv;
#pragma unroll
      for (int x = 0; x < NV; ++x) cv.x[x] = sv[skew<VT>(c + x)];
      reinterpret_cast<Chunk<V, NV>*>(rv)[c / NV] = cv;
    }
  }
  for (int q = full + t; q < n; q += NT) {
    rk[q] = sk[skew<VT>(q)];
    if constexpr (kHasVal<V>) rv[q] = sv[skew<VT>(q)];
  }
}

// VT slots sorted in registers by the direction-free bitonic network (as
// the tiles are sorted, one thread's registers wide): the smaller key to
// the lower register, swapped only when strictly smaller, so the key
// type's maximum loaded past a row's end never moves.
template <typename K, typename V, int VT>
__device__ __forceinline__ void sort_registers(K (&k)[VT], V (&v)[VT]) {
#pragma unroll
  for (int s = 2; s <= VT; s <<= 1) {
#pragma unroll
    for (int i = 0; i < VT; ++i) {  // the flip: i against its mirror
      if ((i ^ (s - 1)) > i) cx(k[i], k[i ^ (s - 1)], v[i], v[i ^ (s - 1)]);
    }
#pragma unroll
    for (int j = s / 4; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < VT; ++i) {
        if (!(i & j)) cx(k[i], k[i | j], v[i], v[i | j]);
      }
    }
  }
}

// The sort of a long row's spans, in place, inside shared memory: block b
// of the grid-stride loop loads span b % spans_per_row (kSpanSlots slots)
// of row b / spans_per_row by asynchronous copies; each thread sorts its
// VT slots in registers; then the runs merge level by level up to one
// (each thread its VT outputs of its pair: merge_serial, a barrier, the
// registers back, a barrier), and the block stores the span.
template <typename K, typename V>
__global__ void __launch_bounds__(kSpanThreads, 1)
sort_spans(K* __restrict__ keys, V* __restrict__ vals, int64_t G, int64_t C,
           int64_t spans_per_row, int vec) {
  constexpr int S = kSpanSlots<K, V>;
  constexpr int VT = S / kSpanThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + smem_slots(S, VT) * sizeof(K));
  const int t = threadIdx.x;
  const int q0 = t * VT;
  const int64_t n_spans = G * spans_per_row;
  for (int64_t b = blockIdx.x; b < n_spans; b += gridDim.x) {
    const int64_t row = b / spans_per_row;
    const int64_t o0 = (b - row * spans_per_row) * S;
    const int n = (int)(C - o0 < S ? C - o0 : S);
    K* rk = keys + row * C + o0;
    V* rv = nullptr;
    if constexpr (kHasVal<V>) rv = vals + row * C + o0;
    for (int j = t; j < n; j += kSpanThreads) {  // every load in flight
      __pipeline_memcpy_async(&sk[skew<VT>(j)], &rk[j], sizeof(K));
      if constexpr (kHasVal<V>) {
        __pipeline_memcpy_async(&sv[skew<VT>(j)], &rv[j], sizeof(V));
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    K k[VT];
    V v[VT];
    if (q0 < n) {
#pragma unroll
      for (int r = 0; r < VT; ++r) {
        const bool real = q0 + r < n;
        k[r] = real ? sk[skew<VT>(q0 + r)] : key_max<K>();
        if constexpr (kHasVal<V>) v[r] = real ? sv[skew<VT>(q0 + r)] : V(-1);
      }
      sort_registers<K, V, VT>(k, v);
      to_smem<K, V, VT>(sk, sv, q0, n, k, v);  // its own slots: no barrier
    }
    __syncthreads();
    for (int w = VT; w < n; w <<= 1) {
      if (q0 < n) {
        const int p0 = q0 & ~(2 * w - 1);
        const int na = n - p0 < w ? n - p0 : w;
        const int nb = (n - p0 < 2 * w ? n - p0 : 2 * w) - na;
        merge_serial<K, V, VT>(sk, sv, p0, na, p0 + na, nb, q0 - p0, k, v);
      }
      __syncthreads();
      if (q0 < n) to_smem<K, V, VT>(sk, sv, q0, n, k, v);
      __syncthreads();
    }
    store_span<K, V, kSpanThreads, VT>(sk, sv, rk, rv, n, t, vec);
    __syncthreads();  // the next span reuses the shared memory
  }
}

// The pair of sorted runs of w slots that output slot o of a row falls in:
// it starts at p0 and is a run of na slots followed by one of nb (0 for a
// lone last run).
struct Pair {
  int64_t p0, na, nb;
  __device__ __forceinline__ Pair(int64_t C, int64_t w, int64_t o) {
    p0 = o & ~(2 * w - 1);
    const int64_t left = C - p0;
    na = left < w ? left : w;
    nb = (left < 2 * w ? left : 2 * w) - na;
  }
};

// parts[s] for span s = (row, j) of a merge pass: where output slot j *
// kMergeSpan of the row splits its pair of runs (the count taken from the
// first run).
template <typename K>
__global__ void __launch_bounds__(kPartThreads)
merge_partition(const K* __restrict__ keys, int64_t G, int64_t C, int64_t w,
                int64_t spans_per_row, int64_t* __restrict__ parts) {
  const int64_t n = G * spans_per_row;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += step) {
    const int64_t row = s / spans_per_row;
    const int64_t o = (s - row * spans_per_row) * kMergeSpan;
    const Pair p(C, w, o);
    const K* a = keys + row * C + p.p0;
    parts[s] = merge_path(a, p.na, a + p.na, p.nb, o - p.p0);
  }
}

// Span s of a merge pass: output slots [out, out + n) (flat), merged from
// the la slots of its pair's a run from in + a and the n - la slots of the
// b run from in + b.  A span ends where its pair ends or where the next
// span's split starts.
struct Span {
  int64_t in, out, a, b;
  int n, la;
  __device__ __forceinline__ Span(int64_t C, int64_t w,
                                  int64_t spans_per_row,
                                  const int64_t* parts, int64_t s) {
    const int64_t row = s / spans_per_row;
    const int64_t o0 = (s - row * spans_per_row) * kMergeSpan;
    n = (int)(C - o0 < kMergeSpan ? C - o0 : kMergeSpan);
    const Pair p(C, w, o0);
    const int64_t d0 = o0 - p.p0;
    const int64_t i0 = parts[s];
    const int64_t i1 = d0 + n == p.na + p.nb ? p.na : parts[s + 1];
    la = (int)(i1 - i0);
    in = row * C + p.p0;
    out = row * C + o0;
    a = i0;
    b = p.na + d0 - i0;
  }
};

// A span's a and b slices into skewed shared memory by asynchronous
// copies (cp.async), committed as one group.
template <typename K, typename V>
__device__ __forceinline__ void load_span(K* sk, V* sv, const K* ik,
                                          const V* iv, const Span& sp,
                                          int t) {
#pragma unroll
  for (int r = 0; r < kMergeVT; ++r) {
    const int j = t + r * kMergeThreads;
    if (j < sp.n) {
      const int64_t src = sp.in + (j < sp.la ? sp.a + j : sp.b + j - sp.la);
      __pipeline_memcpy_async(&sk[skew<kMergeVT>(j)], &ik[src], sizeof(K));
      if constexpr (kHasVal<V>) {
        __pipeline_memcpy_async(&sv[skew<kMergeVT>(j)], &iv[src], sizeof(V));
      }
    }
  }
  __pipeline_commit();
}

// Shared memory of a merge pass block: a buffer a span in flight.
template <typename K, typename V>
constexpr int kMergeSmem =
    kMergeStages * smem_slots(kMergeSpan, kMergeVT) * kSlotBytes<K, V>;

// One merge pass from (ik, iv) into (ok, ov), every pair of runs of w
// slots into one: block b takes spans b, b + gridDim.x, .. (kMergeSpan
// output slots each), the loads of the next kMergeStages - 1 in flight
// while it merges the current one.  parts: the partition launch's
// splits.  vec: the output rows start on 16-byte boundaries (payload
// chunks on their size).
template <typename K, typename V>
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocksPerSm)
merge_pass(const K* __restrict__ ik, const V* __restrict__ iv,
           K* __restrict__ ok, V* __restrict__ ov, int64_t G, int64_t C,
           int64_t w, int64_t spans_per_row,
           const int64_t* __restrict__ parts, int vec) {
  constexpr int VT = kMergeVT;
  constexpr int slots = smem_slots(kMergeSpan, VT);
  extern __shared__ __align__(16) unsigned char smem[];
  K* const sk0 = reinterpret_cast<K*>(smem);
  V* const sv0 = reinterpret_cast<V*>(smem + kMergeStages * slots * sizeof(K));
  const int t = threadIdx.x;
  const int q0 = t * VT;
  const int64_t n_spans = G * spans_per_row;
  const int64_t step = gridDim.x;
  // one group of copies a span, empty past the last
  auto load = [&](int64_t s, int buf) {
    if (s < n_spans) {
      load_span(sk0 + buf * slots, sv0 + buf * slots, ik, iv,
                Span(C, w, spans_per_row, parts, s), t);
    } else {
      __pipeline_commit();
    }
  };
#pragma unroll
  for (int i = 0; i < kMergeStages - 1; ++i) load(blockIdx.x + i * step, i);
  int buf = 0;
  for (int64_t s = blockIdx.x; s < n_spans; s += step) {
    load(s + (kMergeStages - 1) * step, (buf + kMergeStages - 1) % kMergeStages);
    __pipeline_wait_prior(kMergeStages - 1);  // this span's copies landed
    __syncthreads();
    K* sk = sk0 + buf * slots;
    V* sv = sv0 + buf * slots;
    const Span sp(C, w, spans_per_row, parts, s);
    K k[VT];
    V v[VT];
    if (q0 < sp.n) {
      merge_serial<K, V, VT>(sk, sv, 0, sp.la, sp.la, sp.n - sp.la, q0, k, v);
    }
    __syncthreads();
    if (q0 < sp.n) to_smem<K, V, VT>(sk, sv, q0, sp.n, k, v);
    __syncthreads();
    V* rv = nullptr;
    if constexpr (kHasVal<V>) rv = ov + sp.out;
    store_span<K, V, kMergeThreads, VT>(sk, sv, ok + sp.out, rv, sp.n, t,
                                        vec);
    __syncthreads();  // this buffer takes the loads kMergeStages spans on
    buf = (buf + 1) % kMergeStages;
  }
}

// ---- launches --------------------------------------------------------------

template <typename K, typename V, int LOGT>
cudaError_t launch_tiles(K* keys, V* vals, int64_t G, int64_t C, int vec,
                         cudaStream_t s) {
  constexpr int tile = 1 << LOGT;
  constexpr size_t smem =
      (size_t)tile * (sizeof(K) + (kHasVal<V> ? sizeof(V) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_tiles<K, V, LOGT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles_per_row = (C + tile - 1) / tile;
  const int64_t n_tiles = G * tiles_per_row;
  const int grid = (int)(n_tiles < kMaxGrid ? n_tiles : kMaxGrid);
  constexpr int threads = 1 << (LOGT - kLogE);
  sort_tiles<K, V, LOGT><<<grid, threads, smem, s>>>(keys, vals, G, C,
                                                     tiles_per_row, vec);
  return cudaGetLastError();
}

// Merge passes of a row of C slots: one per run width kSpanSlots, twice
// that, .. below C.
template <typename K, typename V>
int merge_passes(int64_t C) {
  int n = 0;
  for (int64_t w = kSpanSlots<K, V>; w < C; w <<= 1) ++n;
  return n;
}

// The buffers of one sort: the rows, and for rows that take merge passes
// the scratch of their shape and the passes' splits.
struct Bufs {
  void* keys;
  void* vals;
  void* skeys;
  void* svals;
  int64_t* parts;
};

// Whether 16-byte accesses fit rows of C slots at these addresses: every
// row must start on a 16-byte boundary (the payload's chunks on one of
// their own size).
template <typename K, typename V>
bool aligned(int64_t C, const void* keys, const void* vals) {
  constexpr int NV = 1 << kLogV<K>;
  constexpr size_t val_chunk =
      kHasVal<V> ? (sizeof(V) * NV < 16 ? sizeof(V) * NV : 16) : 1;
  return C % NV == 0 && (uintptr_t)keys % 16 == 0 &&
         (uintptr_t)vals % val_chunk == 0;
}

// A kernel's dynamic shared memory above the default 48 KB.
template <typename F>
cudaError_t allow_smem(F kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Stage st of the sort.  Rows of up to a tile: stage 0 sorts them whole,
// the later ones do nothing.  Longer rows: 0 sorts their spans of
// kSpanSlots in place (sort_spans), 1 .. passes are the merge passes
// (pass st reads the rows when st is odd and the scratch when it is
// even, and writes the other), and passes + 1 copies the scratch home
// when passes is odd.
template <typename K, typename V>
int run_stage(const Bufs& b, int64_t G, int64_t C, int st, cudaStream_t s) {
  K* keys = static_cast<K*>(b.keys);
  V* vals = static_cast<V*>(b.vals);
  const bool vec = aligned<K, V>(C, b.keys, b.vals);
  const int passes = merge_passes<K, V>(C);
  if (st < 0 || st > passes + 1) return (int)cudaErrorInvalidValue;
  int log_p = 0;
  while (((int64_t)1 << log_p) < C) ++log_p;
  if (log_p <= kMaxLogTile) {
    if (st > 0) return (int)cudaSuccess;
    if (log_p <= kLogWarp) {
      const int64_t blocks = (G + kSmallWarps - 1) / kSmallWarps;
      const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
      sort_small<K, V><<<grid, 32 * kSmallWarps, 0, s>>>(keys, vals, G, C,
                                                         vec);
      return (int)cudaGetLastError();
    }
    switch (log_p) {
      case 9:
        return (int)launch_tiles<K, V, 9>(keys, vals, G, C, vec, s);
      case 10:
        return (int)launch_tiles<K, V, 10>(keys, vals, G, C, vec, s);
      case 11:
        return (int)launch_tiles<K, V, 11>(keys, vals, G, C, vec, s);
      default:
        return (int)launch_tiles<K, V, kMaxLogTile>(keys, vals, G, C, vec,
                                                    s);
    }
  }
  if (st == 0) {
    constexpr int S = kSpanSlots<K, V>;
    constexpr int smem = smem_slots(S, S / kSpanThreads) * kSlotBytes<K, V>;
    const cudaError_t err = allow_smem(sort_spans<K, V>, smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t spans_per_row = (C + S - 1) / S;
    const int64_t n_spans = G * spans_per_row;
    sort_spans<K, V><<<(int)(n_spans < kMaxGrid ? n_spans : kMaxGrid),
                       kSpanThreads, smem, s>>>(keys, vals, G, C,
                                                spans_per_row, vec);
    return (int)cudaGetLastError();
  }
  K* skeys = static_cast<K*>(b.skeys);
  V* svals = static_cast<V*>(b.svals);
  if (st == passes + 1) {
    if (passes % 2 == 0) return (int)cudaSuccess;
    cudaError_t err = cudaMemcpyAsync(keys, skeys, G * C * sizeof(K),
                                      cudaMemcpyDeviceToDevice, s);
    if constexpr (kHasVal<V>) {
      if (err == cudaSuccess) {
        err = cudaMemcpyAsync(vals, svals, G * C * sizeof(V),
                              cudaMemcpyDeviceToDevice, s);
      }
    }
    return (int)err;
  }
  const bool odd = st % 2 == 1;
  const K* ik = odd ? keys : skeys;
  const V* iv = odd ? vals : svals;
  K* ok = odd ? skeys : keys;
  V* ov = odd ? svals : vals;
  const int64_t w = (int64_t)kSpanSlots<K, V> << (st - 1);
  const int64_t spans_per_row = (C + kMergeSpan - 1) / kMergeSpan;
  const int64_t n_spans = G * spans_per_row;
  const int64_t part_blocks = (n_spans + kPartThreads - 1) / kPartThreads;
  merge_partition<K><<<(int)(part_blocks < kMaxGrid ? part_blocks
                                                    : kMaxGrid),
                       kPartThreads, 0, s>>>(ik, G, C, w, spans_per_row,
                                             b.parts);
  // as many blocks as the card holds at once, each looping over spans
  constexpr int smem = kMergeSmem<K, V>;
  cudaError_t err = allow_smem(merge_pass<K, V>, smem);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_pass<K, V>, kMergeThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const bool vec_out = vec && aligned<K, V>(C, b.skeys, b.svals);
  merge_pass<K, V><<<(int)(n_spans < resident ? n_spans : resident),
                     kMergeThreads, smem, s>>>(ik, iv, ok, ov, G, C, w,
                                               spans_per_row, b.parts,
                                               vec_out);
  return (int)cudaGetLastError();
}

template <typename K>
int stage_key(const Bufs& b, int64_t G, int64_t C, int val_bytes, int st,
              cudaStream_t s) {
  switch (val_bytes) {
    case 0:
      return run_stage<K, NoVal>(b, G, C, st, s);
    case 4:
      return run_stage<K, int32_t>(b, G, C, st, s);
    case 8:
      return run_stage<K, int64_t>(b, G, C, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename K, typename V>
int check_key(const Bufs& b, int64_t G, int64_t C) {
  if (G > 0 && merge_passes<K, V>(C) > 0 &&
      (b.skeys == nullptr || b.parts == nullptr ||
       kHasVal<V> != (b.svals != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

template <typename K>
int key_passes(int64_t C, int val_bytes) {
  switch (val_bytes) {
    case 0:
      return merge_passes<K, NoVal>(C);
    case 4:
      return merge_passes<K, int32_t>(C);
    default:
      return merge_passes<K, int64_t>(C);
  }
}

bool valid_sizes(int64_t G, int64_t C, int key_bytes, int val_bytes) {
  return G >= 0 && C >= 0 && (key_bytes == 4 || key_bytes == 8) &&
         (val_bytes == 0 || val_bytes == 4 || val_bytes == 8);
}

// -> the stage count of a sort, or -1 for arguments fk_sort_rows refuses.
int check(const Bufs& b, int64_t G, int64_t C, int key_bytes,
          int val_bytes) {
  if (!valid_sizes(G, C, key_bytes, val_bytes) ||
      (val_bytes != 0) != (b.vals != nullptr)) {
    return -1;
  }
  int err;
  int passes;
  if (key_bytes == 4) {
    passes = key_passes<int32_t>(C, val_bytes);
    err = val_bytes == 0   ? check_key<int32_t, NoVal>(b, G, C)
          : val_bytes == 4 ? check_key<int32_t, int32_t>(b, G, C)
                           : check_key<int32_t, int64_t>(b, G, C);
  } else {
    passes = key_passes<int64_t>(C, val_bytes);
    err = val_bytes == 0   ? check_key<int64_t, NoVal>(b, G, C)
          : val_bytes == 4 ? check_key<int64_t, int32_t>(b, G, C)
                           : check_key<int64_t, int64_t>(b, G, C);
  }
  return err ? -1 : passes + 2;
}

int stage(const Bufs& b, int64_t G, int64_t C, int key_bytes, int val_bytes,
          int st, cudaStream_t s) {
  if (key_bytes == 4) return stage_key<int32_t>(b, G, C, val_bytes, st, s);
  return stage_key<int64_t>(b, G, C, val_bytes, st, s);
}

}  // namespace

// Sort each of the G rows of keys (G x C, row-major, int32 or int64 by
// key_bytes) ascending in place; vals (same shape, int32 or int64 by
// val_bytes; NULL with val_bytes 0) move with their keys.  Rows that take
// merge passes need scratch_keys (and scratch_vals beside vals) of their
// shape and type, whose contents are left undefined, and parts, as many
// int64 as fk_sort_rows_scratch reports; NULL where it reports none.
extern "C" int fk_sort_rows(void* keys, void* vals, void* scratch_keys,
                            void* scratch_vals, void* parts, int64_t G,
                            int64_t C, int key_bytes, int val_bytes,
                            void* stream) {
  const Bufs b{keys, vals, scratch_keys, scratch_vals,
               static_cast<int64_t*>(parts)};
  const int stages = check(b, G, C, key_bytes, val_bytes);
  if (stages < 0) return (int)cudaErrorInvalidValue;
  if (G == 0 || C < 2) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  for (int st = 0; st < stages; ++st) {
    const int err = stage(b, G, C, key_bytes, val_bytes, st, s);
    if (err) return err;
  }
  return (int)cudaSuccess;
}

// What fk_sort_rows needs for G rows of C slots: *long_row is 1 when the
// rows are longer than a tile (the merge sort), *passes the merge passes
// over them, and *parts the int64 entries of the splits (G * ceil(C /
// kMergeSpan); 0 without a pass).  Scratch keys and vals of the rows'
// shape are needed exactly when *passes > 0.  Launches nothing.
extern "C" int fk_sort_rows_scratch(int64_t G, int64_t C, int key_bytes,
                                    int val_bytes, int* long_row, int* passes,
                                    int64_t* parts) {
  if (!valid_sizes(G, C, key_bytes, val_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  *passes = key_bytes == 4 ? key_passes<int32_t>(C, val_bytes)
                           : key_passes<int64_t>(C, val_bytes);
  *long_row = C > (1 << kMaxLogTile);
  *parts = *passes ? G * ((C + kMergeSpan - 1) / kMergeSpan) : 0;
  return (int)cudaSuccess;
}
