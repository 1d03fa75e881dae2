"""C3, the count-of-counts kernel of `histo`: its plain version, its
wrapper on the CPU, and the kernel's own source run on the host.

`count_histo_cuda` (`findkmer_torch/ops/cuda/count_histo_kernel.py`)
launches `csrc/count_histo.cu` for CUDA tensors and runs the plain
version `count_histo_reference` for CPU tensors.  Every case is held to
numpy's `np.bincount(np.minimum(c, m), minlength=m + 1)` over the counts
with the zeros dropped:

  * the wrapper's argument errors, and CPU tensors through the plain
    version with no launch counted;
  * the kernel's source compiled for the host by g++ through a stub of
    the CUDA names it uses (a block's threads are OS threads, a warp's
    `__match_any_sync` an exchange between two barriers of its 32
    threads), with shared and with global bins, from aligned and from
    misaligned addresses;
  * on a card (`cuda` marker, skipped here): the kernel, its launches,
    and a max_count past shared memory (global bins).

Counts are integers: every comparison is exact.  This file does not
import JAX, so its `cuda` tests run on a machine without it
(`python -m pytest --noconftest -m cuda
tests/test_torch_count_histo_kernel.py`).
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from findkmer_torch.ops.cuda import count_histo_kernel as chk

torch.set_num_threads(1)  # six test workers share the cores

SRC = (pathlib.Path(__file__).resolve().parents[1] / "findkmer_torch"
       / "csrc" / "count_histo.cu")


def _counts(kind, n, dtype, seed=0):
    """Counts of one of the spectra's shapes: all ones (a spectrum of
    sequencing errors), all in one bin, 70% ones beside a Poisson
    coverage peak at 40 (with 5% zeros: holes), spread far above the
    clip, or int64 counts past 32 bits."""
    rng = np.random.default_rng(seed)
    if kind == "ones":
        x = np.ones(n, np.int64)
    elif kind == "one_bin":
        x = np.full(n, 37, np.int64)
    elif kind == "poisson":
        x = np.where(rng.random(n) < 0.7, 1, rng.poisson(40, n))
        x[rng.random(n) < 0.05] = 0
    elif kind == "above":
        x = rng.integers(0, 60, n)
    elif kind == "wide":
        x = rng.integers(0, 1 << 40, n)
        low = rng.random(n) < 0.5
        x[low] = rng.integers(1, 9, int(low.sum()))
    else:
        raise ValueError(kind)
    return torch.from_numpy(x.astype(np.int64)).to(dtype)


def _want(counts, max_count):
    c = counts.numpy().astype(np.int64)
    c = c[c != 0]
    return np.bincount(np.minimum(c, max_count), minlength=max_count + 1)


def _misaligned(t):
    """t's values one slot into a buffer: off the 16-byte grid, so the
    kernel reads a head of single entries before its vectors."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    buf[1:] = t
    out = buf[1:]
    assert out.data_ptr() % 16 or not t.numel()
    return out


# (kind, length, dtype, max_count): lengths off any block's and vector's
# multiple, an empty input, one entry
CASES = [
    ("ones", 9001, torch.int32, 10000),
    ("one_bin", 4097, torch.int32, 100),
    ("one_bin", 4097, torch.int64, 20),
    ("poisson", 20011, torch.int32, 10000),
    ("poisson", 20011, torch.int64, 30),
    ("above", 3001, torch.int32, 1),
    ("above", 3001, torch.int64, 3),
    ("above", 7, torch.int32, 5),
    ("wide", 5003, torch.int64, 10000),
    ("ones", 1, torch.int64, 1),
    ("ones", 0, torch.int32, 10000),
]
IDS = [f"{k}-{n}-{str(d)[6:]}-m{m}" for k, n, d, m in CASES]


# ----------------------------------------------------------------------
# the wrapper on the CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    "2d", "float", "int16", "strided", "max0", "max_negative", "max_huge",
])
def test_count_histo_rejects_bad_input(bad):
    counts = torch.ones(10, dtype=torch.int32)
    m = 5
    if bad == "2d":
        counts = counts.reshape(2, 5)
    elif bad == "float":
        counts = counts.float()
    elif bad == "int16":
        counts = counts.to(torch.int16)
    elif bad == "strided":
        counts = torch.ones(20, dtype=torch.int32)[::2]
    elif bad == "max0":
        m = 0
    elif bad == "max_negative":
        m = -3
    elif bad == "max_huge":
        m = 1 << 31
    with pytest.raises((TypeError, ValueError)):
        chk.count_histo_cuda(counts, m)


@pytest.mark.parametrize("kind,n,dtype,m", CASES, ids=IDS)
def test_count_histo_on_cpu_runs_the_plain_version(kind, n, dtype, m):
    counts = _counts(kind, n, dtype, seed=n)
    keep = counts.clone()
    before = chk.count_histo_cuda.launches
    got = chk.count_histo_cuda(counts, m)
    assert chk.count_histo_cuda.launches == before
    assert got.dtype == torch.int64 and got.shape == (m + 1,)
    assert np.array_equal(got.numpy(), _want(counts, m))
    assert got[0] == 0 and torch.equal(counts, keep)


# ----------------------------------------------------------------------
# the kernel's source on the host
# ----------------------------------------------------------------------

# the CUDA names count_histo.cu and bins.cuh use, for g++: a block's
# threads are OS threads (the whole grid at once), __syncthreads a
# barrier of the block, `__match_any_sync` an exchange through a buffer
# between two barriers of the warp's 32 threads; the dynamic shared
# memory is the block's arena; the card has `stub_sms` SMs of one block
_STUB = r"""
#pragma once
#include <pthread.h>

#include <barrier>
#include <cstdint>
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
struct uint4 { unsigned x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchOutOfResources = 7 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int stub_sms = 3;
inline int stub_smem_optin = 8192;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? stub_sms : stub_smem_optin;
  return 0;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
struct StubWarp {
  std::barrier<> bar{32};
  unsigned buf[32];
};
struct StubBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::unique_ptr<StubWarp[]> warps;
  std::vector<char> smem;
};
inline thread_local StubBlock* stub_block;
inline void __syncthreads() { stub_block->bar->arrive_and_wait(); }
inline unsigned __match_any_sync(unsigned, unsigned v) {
  StubWarp& w = stub_block->warps[threadIdx.x / 32];
  w.buf[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)(w.buf[i] == v) << i;
  w.bar.arrive_and_wait();
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
template <class T>
T atomicAdd(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <class T>
T atomicSub(T* p, T v) {
  return __atomic_fetch_sub(p, v, __ATOMIC_SEQ_CST);
}
inline uint32_t* stub_dynamic_smem() {
  return reinterpret_cast<uint32_t*>(stub_block->smem.data());
}
struct StubArg {
  StubBlock* block;
  unsigned b, t;
  const std::function<void()>* f;
};
inline void* stub_thread(void* a) {
  const StubArg* s = static_cast<StubArg*>(a);
  stub_block = s->block;
  blockIdx.x = s->b;
  threadIdx.x = s->t;
  (*s->f)();
  return nullptr;
}
inline unsigned stub_grid = 0;  // blocks of the last launch
inline void stub_launch(unsigned grid, unsigned block, size_t smem,
                        const std::function<void()>& f) {
  gridDim.x = grid;
  blockDim.x = block;
  stub_grid = grid;
  std::vector<StubBlock> blocks(grid);
  for (auto& b : blocks) {
    b.bar = std::make_unique<std::barrier<>>(block);
    b.warps = std::make_unique<StubWarp[]>(block / 32);
    b.smem.assign(smem + 16, (char)0x5a);  // garbage the kernel must zero
  }
  std::vector<StubArg> args;
  for (unsigned i = 0; i < grid; ++i)
    for (unsigned t = 0; t < block; ++t) args.push_back({&blocks[i], i, t, &f});
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, 1 << 17);
  std::vector<pthread_t> th(args.size());
  for (size_t i = 0; i < args.size(); ++i)
    pthread_create(&th[i], &attr, stub_thread, &args[i]);
  for (auto& t : th) pthread_join(t, nullptr);
  pthread_attr_destroy(&attr);
}
#define STUB_LAUNCH(grid, block, smem, ...) \
  stub_launch((grid), (block), (smem), [&]() { __VA_ARGS__; })
extern "C" void fk_stub_sms(int n) { stub_sms = n; }
extern "C" int fk_stub_grid() { return (int)stub_grid; }
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """`fk_count_histo` of csrc/count_histo.cu (with csrc/bins.cuh) built
    by g++ for the host (the dynamic shared array taken from the block's
    arena, the launch replaced by the stub's), loaded with ctypes."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("c3_host")
    (d / "cuda_runtime.h").write_text(_STUB)
    shutil.copy(SRC.parent / "bins.cuh", d / "bins.cuh")
    src = SRC.read_text()
    src, n_smem = re.subn(r"extern __shared__ (\w+) (\w+)\[\];",
                          r"\1* \2 = stub_dynamic_smem();", src)
    src, n_launch = re.subn(
        r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]*>>>\(([^;]*)\);",
        lambda m: f"STUB_LAUNCH({m.group(2)}, {m.group(3)}, {m.group(4)}, "
                  f"{m.group(1)}({m.group(5)}));",
        src, flags=re.S)
    assert (n_smem, n_launch) == (1, 1)
    (d / "count_histo.cpp").write_text(src)
    lib = d / "libc3_host.so"
    res = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas", f"-I{d}", "-o", str(lib),
         str(d / "count_histo.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    so = ctypes.CDLL(str(lib))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    so.fk_count_histo.argtypes = [p, i64, ctypes.c_int, i64, p,
                                  ctypes.c_int, p]
    so.fk_count_histo.restype = ctypes.c_int
    so.fk_count_histo_shared_max.argtypes = [ctypes.POINTER(i64)]
    so.fk_count_histo_shared_max.restype = ctypes.c_int
    so.fk_stub_sms.argtypes = [ctypes.c_int]
    return so


def _host_run(so, counts, m, shared):
    out = torch.zeros(m + 1, dtype=torch.int64)
    err = so.fk_count_histo(counts.data_ptr(), counts.numel(),
                            counts.element_size(), m, out.data_ptr(),
                            int(shared), None)
    assert err == 0
    return out


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "global"])
@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("kind,n,dtype,m", CASES, ids=IDS)
def test_kernel_source_on_host_vs_numpy(host_kernel, kind, n, dtype, m,
                                        shared, aligned):
    counts = _counts(kind, n, dtype, seed=n + 1)
    if not aligned:
        counts = _misaligned(counts)
    got = _host_run(host_kernel, counts, m, shared)
    assert np.array_equal(got.numpy(), _want(counts, m))


def test_kernel_source_on_host_grid_and_limits(host_kernel):
    """One wave of blocks however long the input (the stub's three SMs of
    one block), one block for an input shorter than a vector; the shared
    limit is the opt-in bytes over 4, less bin 0; bad arguments are
    refused before any launch."""
    counts = _counts("poisson", 50001, torch.int32)
    got = _host_run(host_kernel, counts, 64, True)
    assert np.array_equal(got.numpy(), _want(counts, 64))
    assert host_kernel.fk_stub_grid() == 3
    _host_run(host_kernel, _counts("ones", 3, torch.int32), 64, False)
    assert host_kernel.fk_stub_grid() == 1
    top = ctypes.c_int64()
    assert host_kernel.fk_count_histo_shared_max(ctypes.byref(top)) == 0
    assert top.value == 8192 // 4 - 1
    out = torch.zeros(8, dtype=torch.int64)
    for n, nbytes, m in ((5, 2, 7), (5, 4, 0), (-1, 4, 7),
                         (5, 8, 1 << 31)):
        assert host_kernel.fk_count_histo(
            counts.data_ptr(), n, nbytes, m, out.data_ptr(), 0, None) != 0
    assert not out.any()


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run it there with -m cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n,dtype,m", CASES + [
    ("poisson", (1 << 24) + 13, torch.int32, 10000),
    ("wide", (1 << 22) + 3, torch.int64, 10000),
], ids=IDS + ["poisson-16M-int32-m10000", "wide-4M-int64-m10000"])
def test_kernel_vs_plain_on_card(kind, n, dtype, m):
    """The kernel against the plain version and numpy, bit for bit, one
    launch a non-empty input, none for an empty one; from an aligned
    address and one slot off it."""
    _card()
    host = _counts(kind, n, dtype, seed=n + 2)
    want = _want(host, m)
    for counts in (host.cuda(), host.cuda()[1:] if n else None):
        if counts is None:
            continue
        ref = want if counts.numel() == n else _want(host[1:], m)
        before = chk.count_histo_cuda.launches
        got = chk.count_histo_cuda(counts, m)
        assert chk.count_histo_cuda.launches == before + (counts.numel() > 0)
        assert got.device == counts.device and got.dtype == torch.int64
        plain = chk.count_histo_reference(counts, m)
        assert torch.equal(got, plain)
        assert np.array_equal(got.cpu().numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_kernel_global_bins_past_shared_memory_on_card(dtype):
    """A max_count whose bins do not fit a block's shared memory takes
    the global bins (a user's --max-count 1000000); the largest that
    fits keeps them in shared memory."""
    _card()
    top = chk.shared_max_count(torch.cuda.current_device())
    assert 50_000 < top < 70_000  # an H100: 227 KB a block
    host = _counts("above", 1 << 20, dtype) * 4000  # up to 236,000
    for m in (top + 1, 1_000_000, top, 10000):
        before = chk.count_histo_cuda.launches
        got = chk.count_histo_cuda(host.cuda(), m)
        assert chk.count_histo_cuda.launches == before + 1
        assert np.array_equal(got.cpu().numpy(), _want(host, m)), m
