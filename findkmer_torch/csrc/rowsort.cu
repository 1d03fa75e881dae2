// K3 on Hopper: sort every row of a (G, C) key matrix ascending, in place,
// carrying an optional payload (the counts) with each key.
//
// Replaces bench/probe_plsort.py::make_sorter.run / sort_kernel, the Pallas
// bitonic row sorter of the TPU package, which is the row-wise sort of the
// sparse store's compaction (findkmer_tpu/ops/compaction.py,
// findkmer_tpu/ops/sparse.py compact_*_2d / squeeze_2d).  The TPU kernel
// swaps bitonic partners with two pltpu.roll's per stage because Mosaic has
// no gather; here each thread compare-exchanges its partner directly in
// shared memory.
//
// The network is the direction-free bitonic sort: merge size s runs one
// "flip" stage (i against the mirror of i in its s-block) and then
// half-cleaner stages (i against i + j for j = s/4 .. 1), and every
// compare-exchange puts the smaller key at the lower index.  Slots at or past
// C act as +infinity: a pair whose upper index is >= C is skipped, so rows
// of any length sort in place, with no padding and no sentinel values (a
// real key equal to the dtype's max stays distinct from padding, and its
// payload travels with it).  Keys are compared as signed integers.  Ties
// land in any order, as the unstable sorts of the JAX package allow.
//
//   * rows that fit shared memory (next_pow2(C) * (key + payload bytes) <=
//     the block opt-in limit, 227 KB on an H100): one block per row loads
//     the row into dynamic shared memory, runs the whole network with a
//     __syncthreads() between stages and writes it back: one launch.
//   * longer rows (dedup_rows' single row, a raised --sparse-capacity): the
//     row is cut into shared-memory tiles of T slots.  The tiles sort first;
//     then for each merge size s > T the strides >= T run as global-memory
//     compare-exchange passes, one launch per (s, stride), and the tile kernel
//     finishes the strides < T of every tile.
//
// Bound: a row of P = next_pow2(C) slots takes log2(P) (log2(P) + 1) / 2
// stages of P/2 compare-exchanges in shared memory, plus one read and one
// write of the row in device memory (about 8 + 8 B a key for int64 keys).
// The shared-memory traffic and the barriers between stages dominate; a
// register-resident network for the small strides is later work.
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

constexpr int kMaxThreads = 1024;
constexpr int kPassThreads = 256;
constexpr int kPassBlocksPerSm = 32;
constexpr int64_t kMaxGrid = 0x7FFFFFFF;

template <typename V>
constexpr bool kHasVal = !std::is_same<V, NoVal>::value;

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

// Block b of the grid-stride loop sorts tile b % tiles_per_row of row
// b / tiles_per_row.  merge == 0: the whole network up to size `tile`.
// merge == 1: only the half-cleaner strides tile/2 .. 1 (the larger strides
// of the current merge size ran as global passes).
template <typename K, typename V>
__global__ void __launch_bounds__(kMaxThreads)
sort_tiles(K* __restrict__ keys, V* __restrict__ vals, int64_t G, int64_t C,
           int tile, int64_t tiles_per_row, int merge) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  V* sv = reinterpret_cast<V*>(smem + (size_t)tile * sizeof(K));
  const int half = tile >> 1;
  const int64_t n_tiles = G * tiles_per_row;
  for (int64_t b = blockIdx.x; b < n_tiles; b += gridDim.x) {
    const int64_t row = b / tiles_per_row;
    const int64_t t0 = (b - row * tiles_per_row) * tile;
    const int64_t left = C - t0;
    const int n = (int)(left < tile ? left : tile);  // real slots, >= 1
    K* rk = keys + row * C + t0;
    V* rv = nullptr;
    if constexpr (kHasVal<V>) rv = vals + row * C + t0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      sk[i] = rk[i];
      if constexpr (kHasVal<V>) sv[i] = rv[i];
    }
    __syncthreads();
    const int first = merge ? tile : 2;
    for (int size = first; size <= tile; size <<= 1) {
      const int h = size >> 1;
      if (!merge) {
        // flip stage: i in the lower half of its size-block against its
        // mirror in the upper half
        for (int t = threadIdx.x; t < half; t += blockDim.x) {
          const int base = (t / h) * size;
          const int off = t & (h - 1);
          const int p = base + size - 1 - off;
          if (p < n) cmp_swap(sk, sv, base + off, p);
        }
        __syncthreads();
      }
      for (int j = merge ? h : (h >> 1); j > 0; j >>= 1) {
        for (int t = threadIdx.x; t < half; t += blockDim.x) {
          const int i = 2 * t - (t & (j - 1));
          if (i + j < n) cmp_swap(sk, sv, i, i + j);
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      rk[i] = sk[i];
      if constexpr (kHasVal<V>) rv[i] = sv[i];
    }
    __syncthreads();  // the next tile reuses the shared buffer
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

int log2_floor(int64_t x) {
  int l = 0;
  while (((int64_t)1 << (l + 1)) <= x) ++l;
  return l;
}

template <typename K, typename V>
int run(void* keys_, void* vals_, int64_t G, int64_t C, cudaStream_t s) {
  K* keys = static_cast<K*>(keys_);
  V* vals = static_cast<V*>(vals_);
  int dev = 0;
  int smem_max = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  const int64_t slot = (int64_t)sizeof(K) + (kHasVal<V> ? sizeof(V) : 0);
  int64_t P = 1;
  while (P < C) P <<= 1;
  const int64_t T = (int64_t)1 << log2_floor(smem_max / slot);
  const int tile = (int)(P < T ? P : T);
  int threads = tile / 2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)tile * slot;
  err = cudaFuncSetAttribute(sort_tiles<K, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles_per_row = (C + tile - 1) / tile;
  const int64_t n_tiles = G * tiles_per_row;
  const int tile_grid = (int)(n_tiles < kMaxGrid ? n_tiles : kMaxGrid);

  sort_tiles<K, V><<<tile_grid, threads, smem, s>>>(
      keys, vals, G, C, tile, tiles_per_row, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (P <= tile) return (int)cudaSuccess;

  const int log_half_p = log2_floor(P) - 1;
  const int64_t pairs = G * (P >> 1);
  int64_t need = (pairs + kPassThreads - 1) / kPassThreads;
  const int64_t cap = (int64_t)sms * kPassBlocksPerSm;
  const int pass_grid = (int)(need < cap ? need : cap);
  for (int64_t size = 2 * (int64_t)tile; size <= P; size <<= 1) {
    sort_pass<K, V><<<pass_grid, kPassThreads, 0, s>>>(
        keys, vals, G, C, log_half_p, size, size >> 1, 1);
    for (int64_t j = size >> 2; j >= tile; j >>= 1) {
      sort_pass<K, V><<<pass_grid, kPassThreads, 0, s>>>(
          keys, vals, G, C, log_half_p, size, j, 0);
    }
    sort_tiles<K, V><<<tile_grid, threads, smem, s>>>(
        keys, vals, G, C, tile, tiles_per_row, 1);
    err = cudaGetLastError();
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
