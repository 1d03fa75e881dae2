"""C2, the run-length encoding of the sparse store's sorted rows: its plain
version, its wrapper on the CPU, and the kernel's own source run on the
host.

`rle_rows_cuda` (`findkmer_torch/ops/cuda/rle_kernel.py`) launches
`csrc/rle.cu` for CUDA tensors and runs the plain version
`rle_rows_reference` (the torch chain of cummax, cumsum and gather) for
CPU tensors.  Here:

  * the wrapper's argument errors, and CPU tensors through the plain
    version with no launch counted and the counts untouched;
  * `ops/sparse.rle_pos_2d` / `rle_val_2d` (the plain version on the CPU)
    against the JAX package's on rows `tests/test_torch_sparse.py` lacks:
    one row of 2^16 + 7 slots whose runs straddle every power of two, a
    row that is one run, a row of sentinels, a row ending on a live code;
  * the compactions hand their `plain` on to the run-length encoding;
  * the kernel's source compiled for the host by g++ through a stub of the
    CUDA names it uses (a block's threads are OS threads, a few blocks at
    a time, so the tiles' look-back runs against tiles still in flight),
    held to the plain version slot for slot;
  * on a card (`cuda` marker, skipped here): the kernel against the plain
    version, and its counted mode in place.

Codes and counts are integers: every comparison is exact.  This file does
not import JAX at the top, so its `cuda` tests run on a machine without
it (`python -m pytest --noconftest -m cuda tests/test_torch_rle_kernel.py`).
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from findkmer_torch.ops import compaction, sparse
from findkmer_torch.ops.cuda import rle_kernel as rlk
from findkmer_torch.ops.window import code_dtype, sentinel

torch.set_num_threads(1)  # six test workers share the cores

SRC = (pathlib.Path(__file__).resolve().parents[1] / "findkmer_torch"
       / "csrc" / "rle.cu")
SENT64 = sentinel(torch.int64)


def _sorted_rows(shape, dtype, pool, sent_share, seed):
    """Rows of codes from a pool of `pool` values, a share of them the
    sentinel, each row sorted."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, pool, shape).astype(np.int64)
    x[rng.random(shape) < sent_share] = sentinel(dtype)
    x.sort(axis=1)
    return torch.from_numpy(x).to(dtype)


def _counts(shape, dtype, seed, top=9):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, top, shape)).to(dtype)


# ----------------------------------------------------------------------
# the wrapper on the CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    "1d", "3d", "float", "uint8", "strided", "count_dtype", "cnt_shape",
    "cnt_float", "cnt_int16", "cnt_strided",
])
def test_rle_rows_rejects_bad_input(bad):
    codes = torch.zeros((4, 10), dtype=torch.int64)
    cnt = None
    cdt = torch.int32
    if bad == "1d":
        codes = codes.reshape(-1)
    elif bad == "3d":
        codes = codes.reshape(2, 2, 10)
    elif bad == "float":
        codes = codes.double()
    elif bad == "uint8":
        codes = codes.to(torch.uint8)
    elif bad == "strided":
        codes = codes[:, ::2]
    elif bad == "count_dtype":
        cdt = torch.int16
    elif bad == "cnt_shape":
        cnt = torch.zeros((4, 5), dtype=torch.int32)
    elif bad == "cnt_float":
        cnt = torch.zeros((4, 10))
    elif bad == "cnt_int16":
        cnt = torch.zeros((4, 10), dtype=torch.int16)
    elif bad == "cnt_strided":
        cnt = torch.zeros((4, 20), dtype=torch.int32)[:, ::2]
    for plain in (False, True):
        with pytest.raises((ValueError, TypeError)):
            rlk.rle_rows(codes, cnt, cdt, plain=plain)
    with pytest.raises((ValueError, TypeError)):
        rlk.rle_rows_cuda(codes, cnt, cdt)


@pytest.mark.parametrize("cdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("kd", [torch.int32, torch.int64])
def test_rle_rows_cuda_on_cpu_runs_the_plain_version(kd, cdt):
    codes = _sorted_rows((6, 301), kd, 40, 0.2, seed=3)
    cnt = _counts(codes.shape, cdt, seed=4)
    keep = codes.clone(), cnt.clone()
    before = rlk.rle_rows_cuda.launches, rlk.rle_rows_cuda.long_launches
    got = rlk.rle_rows_cuda(codes, None, cdt)
    assert got.dtype == cdt
    assert torch.equal(got, rlk.rle_rows_reference(codes, None, cdt))
    got = rlk.rle_rows_cuda(codes, cnt)
    assert got is not cnt and got.dtype == cdt
    assert torch.equal(got, rlk.rle_rows_reference(codes, cnt))
    # the plain version is no launch, and leaves its inputs as they were
    assert (rlk.rle_rows_cuda.launches,
            rlk.rle_rows_cuda.long_launches) == before
    assert torch.equal(codes, keep[0]) and torch.equal(cnt, keep[1])
    assert torch.equal(rlk.rle_rows(codes, cnt, plain=True), got)


def test_rle_rows_empty():
    for shape in ((0, 5), (3, 0)):
        codes = torch.zeros(shape, dtype=torch.int64)
        assert rlk.rle_rows(codes).shape == shape
        cnt = torch.zeros(shape, dtype=torch.int64)
        assert rlk.rle_rows(codes, cnt).dtype == torch.int64


@pytest.mark.parametrize("fn", ["raw", "counted", "dedup"])
def test_compactions_pass_plain_to_the_encoding(fn, monkeypatch):
    """compact_raw_2d / compact_counted_2d (so every compaction and the
    cross-row dedup) encode through `rle_rows` with their own `plain`."""
    seen = []
    orig = sparse.rle_rows

    def tap(codes, cnt=None, count_dtype=torch.int32, plain=False):
        seen.append((cnt is None, count_dtype, plain))
        return orig(codes, cnt, count_dtype, plain)

    monkeypatch.setattr(sparse, "rle_rows", tap)
    raw = _sorted_rows((8, 64), torch.int64, 30, 0.1, seed=5)
    raw = raw[:, torch.randperm(64)].contiguous()
    for plain in (False, True):
        if fn == "raw":
            sparse.compact_raw_2d(raw.clone(), torch.int64, plain=plain)
            assert seen.pop() == (True, torch.int64, plain)
        elif fn == "counted":
            sparse.compact_counted_2d(raw.clone(), _counts(raw.shape,
                                                           torch.int32, 6),
                                      plain=plain)
            assert seen.pop() == (False, torch.int32, plain)
        else:
            store, _ = compaction.compact_raw_rows(raw.clone(), 8, 64,
                                                   torch.int32, plain)
            assert seen.pop() == (True, torch.int32, plain)
            compaction.dedup_rows(store, 1, 8, 16, plain)
            assert seen.pop() == (False, torch.int32, plain)
        assert not seen


# ----------------------------------------------------------------------
# the plain version against the JAX package
# ----------------------------------------------------------------------

def _straddling_row(n, seed):
    """One sorted row of n slots: a run starts one slot before every power
    of two (so the run holds 2^i - 1 and 2^i), short runs between, the
    last 5 slots the sentinel."""
    rng = np.random.default_rng(seed)
    starts = {0} | {(1 << i) - 1 for i in range(1, 17) if (1 << i) < n}
    starts |= set(rng.integers(1, n, 200).tolist())
    starts -= {(1 << i) for i in range(1, 17)}
    flags = np.zeros(n, bool)
    flags[sorted(starts)] = True
    row = np.cumsum(flags) * 3 + 1000
    row[-5:] = SENT64
    return row[None, :]


def _case_rows(case):
    """(1, C) int64 rows of the cases test_rle_vs_jax lacks."""
    if case == "straddle":
        return _straddling_row((1 << 16) + 7, seed=7)
    if case == "one_run":
        return np.full((1, 1000), 1234567, np.int64)
    if case == "all_sentinel":
        return np.full((1, 1000), SENT64, np.int64)
    row = np.sort(np.random.default_rng(8).integers(0, 30, 999))
    return row[None, :].astype(np.int64)  # "live_last": no sentinel


def _jax_planes(codes, k):
    """Port codes (int64 numpy, port sentinel) -> the JAX package's code
    planes (hi, lo), and whether they are wide."""
    from findkmer_tpu.ops import sparse as jsparse

    sent = codes == sentinel(code_dtype(k))
    lo = np.where(sent, 0xFFFFFFFF, codes & 0xFFFFFFFF).astype(np.uint32)
    if k <= 15:
        return np.zeros_like(lo), lo, False
    hdt = jsparse.hi_dtype(k)
    hi = np.where(sent, jsparse.sent_of(hdt), codes >> 32).astype(hdt)
    return hi, lo, True


@pytest.mark.parametrize("mode", ["implicit", "counted"])
@pytest.mark.parametrize("k", [11, 21])
@pytest.mark.parametrize("case", ["straddle", "one_run", "all_sentinel",
                                  "live_last"])
def test_rle_plain_vs_jax(case, k, mode):
    import jax.numpy as jnp

    from findkmer_tpu.ops import sparse as jsparse

    dt = code_dtype(k)
    rows = _case_rows(case)
    rows = np.where(rows == SENT64, sentinel(dt), rows)
    codes = torch.from_numpy(rows.astype(np.int64)).to(dt)
    hi, lo, wide = _jax_planes(rows.astype(np.int64), k)
    if mode == "implicit":
        want = np.asarray(jsparse.rle_pos_2d(jnp.asarray(hi), jnp.asarray(lo),
                                             wide=wide))
        got = sparse.rle_pos_2d(codes)
        assert got.dtype == torch.int32
    else:
        cnt = _counts(rows.shape, torch.int32, seed=9, top=1 << 20)
        want = np.asarray(jsparse.rle_val_2d(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(cnt.numpy()),
            wide=wide))
        got = sparse.rle_val_2d(codes, cnt)
    np.testing.assert_array_equal(got.numpy(), want)
    live_totals = int((got != 0).sum())
    if case == "one_run":
        assert live_totals == 1 and int(got[0, -1]) == int(want[0, -1])
    elif case == "all_sentinel":
        assert live_totals == 0
    elif case == "live_last":
        assert int(got[0, -1]) > 0
    else:  # every run of the straddling row: one total each
        assert live_totals == len(np.unique(rows[rows != sentinel(dt)]))


# ----------------------------------------------------------------------
# the kernel's source on the host
# ----------------------------------------------------------------------

# the CUDA names rle.cu uses, for g++: a block's threads are OS threads
# (`stub_wave` blocks at a time: a block waits only on tiles taken before
# its own, by blocks beside it or finished), __syncthreads a barrier of
# the block, a warp's shuffles and ballots an exchange through a buffer
# between two barriers of its 32 threads; __shared__ variables come from
# the block's arena, in the order the threads declare them
_STUB = r"""
#pragma once
#include <pthread.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

struct stub_dim3 { unsigned x = 0, y = 1, z = 1; };
inline thread_local stub_dim3 blockIdx, threadIdx;
inline stub_dim3 blockDim, gridDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0;
const int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
struct StubWarp {
  std::barrier<> bar{32};
  uint64_t buf[32];
};
struct StubBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::unique_ptr<StubWarp[]> warps;
  std::vector<char> smem;
};
inline thread_local StubBlock* stub_block;
inline thread_local size_t stub_smem_off;
inline void __syncthreads() { stub_block->bar->arrive_and_wait(); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
template <class T>
T* stub_shared() {
  const size_t a = alignof(T);
  stub_smem_off = (stub_smem_off + a - 1) / a * a;
  T* p = reinterpret_cast<T*>(stub_block->smem.data() + stub_smem_off);
  stub_smem_off += sizeof(T);
  return p;
}
template <class T>
T stub_shfl(T v, int src) {
  StubWarp& w = stub_block->warps[threadIdx.x / 32];
  uint64_t x = 0;
  std::memcpy(&x, &v, sizeof(T));
  w.buf[threadIdx.x % 32] = x;
  w.bar.arrive_and_wait();
  const uint64_t y = w.buf[src];
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, &y, sizeof(T));
  return r;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) { return stub_shfl(v, src); }
template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  const int l = threadIdx.x % 32;
  return stub_shfl(v, l >= d ? l - d : l);
}
template <class T>
T __shfl_down_sync(unsigned, T v, int d) {
  const int l = threadIdx.x % 32;
  return stub_shfl(v, l + d < 32 ? l + d : l);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int m) {
  return stub_shfl(v, (threadIdx.x % 32) ^ m);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  StubWarp& w = stub_block->warps[threadIdx.x / 32];
  w.buf[threadIdx.x % 32] = p;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)(w.buf[i] != 0) << i;
  w.bar.arrive_and_wait();
  return m;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
struct StubArg {
  StubBlock* block;
  unsigned b, t;
  const std::function<void()>* f;
};
inline void* stub_thread(void* a) {
  const StubArg* s = static_cast<StubArg*>(a);
  stub_block = s->block;
  stub_smem_off = 0;
  blockIdx.x = s->b;
  threadIdx.x = s->t;
  (*s->f)();
  return nullptr;
}
inline unsigned stub_wave = 3;
inline void stub_launch(unsigned grid, unsigned block,
                        const std::function<void()>& f) {
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned b0 = 0; b0 < grid; b0 += stub_wave) {
    const unsigned nb = std::min(stub_wave, grid - b0);
    std::vector<StubBlock> blocks(nb);
    for (auto& b : blocks) {
      b.bar = std::make_unique<std::barrier<>>(block);
      b.warps = std::make_unique<StubWarp[]>(block / 32);
      b.smem.assign(4096, 0);
    }
    std::vector<StubArg> args;
    for (unsigned i = 0; i < nb; ++i)
      for (unsigned t = 0; t < block; ++t)
        args.push_back({&blocks[i], b0 + i, t, &f});
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setstacksize(&attr, 1 << 18);
    std::vector<pthread_t> th(args.size());
    for (size_t i = 0; i < args.size(); ++i)
      pthread_create(&th[i], &attr, stub_thread, &args[i]);
    for (auto& t : th) pthread_join(t, nullptr);
    pthread_attr_destroy(&attr);
  }
}
#define STUB_LAUNCH(grid, block, ...) \
  stub_launch((grid), (block), [&]() { __VA_ARGS__; })
extern "C" void fk_stub_wave(int w) { stub_wave = (unsigned)w; }
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """`fk_rle_rows` of csrc/rle.cu built by g++ for the host (each
    `__shared__` variable taken from the block's arena, the launch
    replaced by the stub's), loaded with ctypes."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("c2_host")
    (d / "cuda_runtime.h").write_text(_STUB)
    src = SRC.read_text()
    src, n_arr = re.subn(r"__shared__ ([\w:]+) (\w+)\[(\w+)\];",
                         r"\1 (&\2)[\3] = *stub_shared<\1[\3]>();", src)
    src, n_var = re.subn(r"__shared__ ([\w:]+) (\w+);",
                         r"\1& \2 = *stub_shared<\1>();", src)
    src, n_launch = re.subn(
        r"(rle_rows<[^<>]*>)<<<([^,]+), ([^,]+), [^>]*>>>\(([^;]*)\);",
        lambda m: f"STUB_LAUNCH({m.group(2)}, {m.group(3)}, "
                  f"{m.group(1)}({m.group(4)}));",
        src, flags=re.S)
    assert (n_arr, n_var, n_launch) == (1, 2, 1)
    (d / "rle.cpp").write_text(src)
    lib = d / "libc2_host.so"
    res = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{d}", "-o", str(lib), str(d / "rle.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    so = ctypes.CDLL(str(lib))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    so.fk_rle_rows.argtypes = [p, p, p, i64, i64, ctypes.c_int,
                               ctypes.c_int, p, p]
    so.fk_rle_rows.restype = ctypes.c_int
    so.fk_rle_rows_status_words.argtypes = [i64]
    so.fk_rle_rows_status_words.restype = i64
    so.fk_rle_rows_tile.restype = i64
    so.fk_stub_wave.argtypes = [ctypes.c_int]
    return so


def _host_run(so, codes, cnt=None, cdt=torch.int32):
    R, C = codes.shape
    out = torch.full(codes.shape, 77, dtype=cdt) if cnt is None else cnt
    status = torch.full((so.fk_rle_rows_status_words(R * C),), -1,
                        dtype=torch.int64)
    err = so.fk_rle_rows(codes.data_ptr(),
                         None if cnt is None else cnt.data_ptr(),
                         out.data_ptr(), R, C, codes.element_size(),
                         out.element_size(), status.data_ptr(), None)
    assert err == 0
    return out


def _misaligned(t):
    """t's values in a tensor of its shape one slot into a buffer: its
    address is off the 16-byte grid, so the kernel takes single loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    buf[1:] = t.reshape(-1)
    out = buf[1:].view(t.shape)
    assert out.data_ptr() % 16
    return out


HOST_CASES = [
    # (name, shape, key dtype, pool, sentinel share)
    ("tiny", (5, 7), torch.int64, 3, 0.2),
    ("one_slot_rows", (9, 1), torch.int32, 2, 0.3),
    ("rows_in_a_tile", (4, 300), torch.int32, 50, 0.2),
    ("rows_across_tiles", (7, 768), torch.int64, 200, 0.1),
    ("tile_and_one", (3, 4097), torch.int64, 1000, 0.05),
    ("long_row", (1, 20000), torch.int64, 60, 0.0),
    ("long_row_int32", (2, 9001), torch.int32, 7, 0.1),
]


@pytest.mark.parametrize("mode", ["implicit", "counted"])
@pytest.mark.parametrize("name,shape,kd,pool,sent", HOST_CASES)
def test_kernel_source_on_host_vs_plain(host_kernel, name, shape, kd, pool,
                                        sent, mode):
    codes = _sorted_rows(shape, kd, pool, sent, seed=len(name))
    for cdt in (torch.int32, torch.int64):
        if mode == "implicit":
            want = rlk.rle_rows_reference(codes, None, cdt)
            got = _host_run(host_kernel, codes, None, cdt)
        else:
            cnt = _counts(shape, cdt, seed=11, top=1 << 30)
            want = rlk.rle_rows_reference(codes, cnt)
            got = _host_run(host_kernel, codes, cnt)  # in place
            assert got is cnt
        assert torch.equal(got, want), (name, cdt)


@pytest.mark.parametrize("case", ["one_key", "wrap", "misaligned",
                                  "unsorted"])
def test_kernel_source_on_host_edges(host_kernel, case):
    """A run over eleven tiles with twelve blocks in flight (tiles publish
    aggregates and look back 32 at a time), the running sum's wrap, single
    loads off the 16-byte grid, and rows that are not sorted (the plain
    version's flags then still define every slot's output)."""
    if case == "one_key":
        host_kernel.fk_stub_wave(12)
        try:
            codes = torch.full((1, 45001), 5, dtype=torch.int64)
            assert torch.equal(_host_run(host_kernel, codes),
                               rlk.rle_rows_reference(codes))
            cnt = _counts(codes.shape, torch.int64, seed=12, top=1 << 40)
            want = rlk.rle_rows_reference(codes, cnt)
            assert torch.equal(_host_run(host_kernel, codes, cnt), want)
        finally:
            host_kernel.fk_stub_wave(3)
    elif case == "wrap":
        for dt, big in ((torch.int32, 2_000_000_000),
                        (torch.int64, (1 << 62) + 3)):
            codes = torch.tensor([[1, 2, 3, 4, 4, 5, SENT64]])
            cnt = torch.tensor([[big, big, big, 5, 1, 7, 0]], dtype=dt)
            got = _host_run(host_kernel, codes, cnt)
            assert got.tolist() == [[big, big, big, 0, 6, 7, 0]]
    elif case == "misaligned":
        for kd in (torch.int32, torch.int64):
            codes = _misaligned(_sorted_rows((5, 1001), kd, 40, 0.1, 13))
            assert torch.equal(_host_run(host_kernel, codes),
                               rlk.rle_rows_reference(codes))
            cnt = _misaligned(_counts(codes.shape, torch.int32, seed=14))
            want = rlk.rle_rows_reference(codes, cnt)
            assert torch.equal(_host_run(host_kernel, codes, cnt), want)
    else:
        rng = np.random.default_rng(15)
        for kd in (torch.int32, torch.int64):
            x = rng.integers(-3, 3, (6, 999)).astype(np.int64)
            x[rng.random(x.shape) < 0.3] = sentinel(kd)
            codes = torch.from_numpy(x).to(kd)
            assert torch.equal(_host_run(host_kernel, codes),
                               rlk.rle_rows_reference(codes))
            cnt = torch.from_numpy(rng.integers(-5, 9, x.shape))
            want = rlk.rle_rows_reference(codes, cnt)
            assert torch.equal(_host_run(host_kernel, codes, cnt), want)


def test_kernel_status_words_and_tile(host_kernel):
    """The look-back's words: a counter, then a status, an aggregate and
    an inclusive sum a tile of 4096 slots; the wrapper's long launches are
    rows longer than that."""
    tile = host_kernel.fk_rle_rows_tile()
    assert tile == 4096
    for n, tiles in ((1, 1), (4096, 1), (4097, 2), (1 << 29, 1 << 17)):
        assert host_kernel.fk_rle_rows_status_words(n) == 1 + 3 * tiles


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")


CARD_CASES = [
    # (name, shape, key dtype, count dtype or None: implicit)
    ("raw_k21", (262144, 1024), torch.int64, None),
    ("counted_k21", (4096, 2048), torch.int64, torch.int32),
    ("raw_k15", (1024, 768), torch.int32, None),
    ("counted_k15", (1024, 768), torch.int32, torch.int64),
    ("long_row", (1, (1 << 24) + 5), torch.int64, torch.int32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,kd,cdt", CARD_CASES)
def test_kernel_vs_plain_on_card(name, shape, kd, cdt):
    """The kernel against the plain version, bit for bit; the long row's
    runs (a pool of 2^20 codes over 2^24 slots: runs of ~16 slots, some
    across tiles) take the look-back on every tile."""
    _card()
    pool = 1 << 20 if name == "long_row" else 300
    codes = _sorted_rows(shape, kd, pool, 0.1, seed=16).cuda()
    cnt = None if cdt is None else _counts(shape, cdt, seed=17,
                                           top=1 << 20).cuda()
    want = rlk.rle_rows_reference(codes, cnt, cdt or torch.int32)
    before = rlk.rle_rows_cuda.launches, rlk.rle_rows_cuda.long_launches
    got = rlk.rle_rows_cuda(codes, cnt, cdt or torch.int32)
    torch.cuda.synchronize()
    assert rlk.rle_rows_cuda.launches == before[0] + 1
    assert (rlk.rle_rows_cuda.long_launches
            == before[1] + (shape[1] > rlk.tile()))
    assert got.dtype == want.dtype and torch.equal(got, want)
    if cnt is not None:
        assert got is cnt


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.int32, torch.int64])
def test_kernel_exact_when_the_running_sum_wraps_on_card(dt):
    _card()
    big = 2_000_000_000 if dt == torch.int32 else (1 << 62) + 3
    codes = torch.tensor([[1, 2, 3, 4, 4, 5, SENT64]], device="cuda")
    cnt = torch.tensor([[big, big, big, 5, 1, 7, 0]], dtype=dt,
                       device="cuda")
    got = rlk.rle_rows_cuda(codes, cnt)
    assert got.tolist() == [[big, big, big, 0, 6, 7, 0]]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["implicit", "counted"])
def test_kernel_memory_and_inputs_on_card(mode):
    """Counted mode writes over the counts and leaves the codes as they
    were; the device's peak grows by the implicit output (implicit mode)
    and the tile status words, nothing the size of the store else."""
    _card()
    shape = (4096, 2048)
    codes = _sorted_rows(shape, torch.int64, 300, 0.1, seed=18).cuda()
    cnt = _counts(shape, torch.int32, seed=19).cuda()
    keep = codes.clone()
    want = rlk.rle_rows_reference(codes, None if mode == "implicit" else cnt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = rlk.rle_rows_cuda(codes, None if mode == "implicit" else cnt)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base

    def block(nbytes):  # the caching allocator's rounding
        return -(-nbytes // 512) * 512

    status = 8 * (1 + 3 * -(-codes.numel() // rlk.tile()))
    out = 4 * codes.numel() if mode == "implicit" else 0
    assert grew <= block(status) + block(out)
    assert torch.equal(codes, keep) and torch.equal(got, want)
    if mode == "counted":
        assert got is cnt
