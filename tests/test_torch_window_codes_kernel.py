"""C1, the sparse path's window extraction: its wrapper on the CPU, the
call sites that reach it, and the kernel's own source run on the host.

`window_codes_packed_cuda` (`findkmer_torch/ops/cuda/window_codes_kernel.
py`) launches `csrc/window_codes.cu` for CUDA tensors and runs the plain
version `ops/window.window_codes_packed` for CPU tensors.  Here:

  * the wrapper on CPU tensors gives the plain version's slots at every k,
    fwd and canonical, on random wire with invalid bases, all invalid,
    poly-A and poly-T, rows of exactly k bases, validity rows of an odd
    byte count, R trimming, and `out=` into the middle of a marked buffer
    (the JAX package's slots: `tests/test_torch_window.py`);
  * its argument errors, and no launch counted on the CPU;
  * `counter.ingest` (so `KmerCounter.step`, dp_sparse, `--per-record`,
    `stream`, `bench`) and `filter_device._filter_step` reach it;
  * the kernel's source compiled for the host by g++ through a stub of the
    few CUDA names it uses (one thread after another, in block order), held
    to the plain version slot for slot: its arithmetic without a card;
  * on a card (`cuda` marker, skipped here): the kernel against the plain
    version.

Codes are integers: every comparison is exact (`torch.equal`).
"""

import ctypes
import os
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from findkmer_torch import Config, filter as port_filter, filter_device
from findkmer_torch import pipeline
from findkmer_torch.models import counter as counter_mod
from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda import window_codes_kernel as wck
from oracle.scalar import count_fasta_file

torch.set_num_threads(1)  # six test workers share the cores

SRC = (pathlib.Path(__file__).resolve().parents[1] / "findkmer_torch"
       / "csrc" / "window_codes.cu")
ALL_KS = list(range(1, 32))
CASES = ("random", "invalid", "poly_a", "poly_t")


def _wire(case, k, b=3, ln=61, seed=0):
    """(packed, validbits, R) of b rows cut from a seeded stream the way
    the host batcher cuts them (row i = work[i*ln : i*ln + R], R = ln + k
    - 1), packed by the port's numpy packer."""
    rng = np.random.default_rng(1000 * k + seed)
    R = ln + k - 1
    n = k - 1 + b * ln
    if case == "random":
        work = rng.integers(0, 4, n).astype(np.uint8)
        work[rng.random(n) < 0.02] = window_ops.INVALID
    elif case == "invalid":
        work = np.full(n, window_ops.INVALID, np.uint8)
    elif case == "poly_a":
        work = np.zeros(n, np.uint8)
    elif case == "poly_t":
        work = np.full(n, 3, np.uint8)
    else:
        raise ValueError(case)
    packed, validbits = pipeline._numpy_pack_rows(work, b, ln, R,
                                                  (R + 7) // 8 * 8)
    return torch.from_numpy(packed), torch.from_numpy(validbits), R


def _geometries(k):
    """(rows, owned bases a row): the batcher's odd geometry; rows of
    exactly k bases; rows whose validity bytes are odd in number (R8 =
    1016: 254 packed, 127 validity bytes); a row of 16 words or more."""
    return ((3, 61), (2, 1), (5, 1011 - k), (1, 300))


# ----------------------------------------------------------------------
# the wrapper on the CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", ALL_KS)
def test_wrapper_on_cpu_equals_plain(k, canonical):
    before = wck.window_codes_packed_cuda.launches
    for case in CASES:
        for b, ln in _geometries(k):
            packed, validbits, R = _wire(case, k, b, ln)
            for r in (R, 0, max(R - 5, 1)):
                want = window_ops.window_codes_packed(packed, validbits, k,
                                                      canonical, R=r)
                got = wck.window_codes_packed_cuda(packed, validbits, k,
                                                   canonical, R=r)
                assert got.dtype == window_ops.code_dtype(k)
                assert torch.equal(got, want), (case, b, ln, r)
                # out= into the middle of a buffer filled with a marker
                buf = torch.full((want.numel() + 7,), -3, dtype=want.dtype)
                ret = wck.window_codes_packed_cuda(
                    packed, validbits, k, canonical, R=r,
                    out=buf[3 : 3 + want.numel()])
                assert (not want.numel()
                        or ret.data_ptr() == buf[3:].data_ptr())
                assert torch.equal(buf[3 : 3 + want.numel()], want)
                assert (buf[:3] == -3).all() and (buf[-4:] == -3).all()
    assert wck.window_codes_packed_cuda.launches == before  # no launch


@pytest.mark.parametrize("k", [16, 21, 29, 31])
def test_poly_t_is_a_real_code_below_the_sentinel(k):
    """Poly-T windows are 4^k - 1 (all ones), valid, just under the
    sentinel; all-invalid rows are the sentinel alone."""
    packed, validbits, R = _wire("poly_t", k, b=2, ln=40)
    got = wck.window_codes_packed_cuda(packed, validbits, k, R=R)
    sent = window_ops.sentinel(got.dtype)
    real = got[got != sent]
    assert real.numel() and bool((real == 4 ** k - 1).all())
    assert 4 ** k - 1 < sent
    packed, validbits, R = _wire("invalid", k, b=2, ln=40)
    assert bool((wck.window_codes_packed_cuda(packed, validbits, k, R=R)
                 == sent).all())


@pytest.mark.parametrize("bad", [
    "k0", "k32", "packed_int8", "validbits_int32", "packed_1d", "strided",
    "rows_mismatch", "widths", "devices", "meta",
])
def test_wrapper_rejects_bad_input(bad):
    packed = torch.zeros((4, 6), dtype=torch.uint8)
    validbits = torch.zeros((4, 3), dtype=torch.uint8)
    k = 21
    if bad == "k0":
        k = 0
    elif bad == "k32":
        k = 32
    elif bad == "packed_int8":
        packed = packed.to(torch.int8)
    elif bad == "validbits_int32":
        validbits = validbits.int()
    elif bad == "packed_1d":
        packed = packed.reshape(-1)
    elif bad == "strided":
        packed = torch.zeros((4, 12), dtype=torch.uint8)[:, ::2]
    elif bad == "rows_mismatch":
        validbits = validbits[:3]
    elif bad == "widths":
        validbits = torch.zeros((4, 4), dtype=torch.uint8)
    elif bad == "devices":
        validbits = validbits.to("meta")
    elif bad == "meta":
        packed, validbits = packed.to("meta"), validbits.to("meta")
    with pytest.raises((ValueError, TypeError)):
        wck.window_codes_packed_cuda(packed, validbits, k, R=21)


def test_wrapper_checks_out_as_the_plain_version():
    """A wrong `out` raises the plain version's ValueError text; a strided
    one raises too."""
    packed = torch.zeros((2, 8), dtype=torch.uint8)
    validbits = packed[:, :4].contiguous()
    n = window_ops.packed_slots(2, 8, 21, 30)
    for out in (torch.empty(n, dtype=torch.int32),
                torch.empty(n + 1, dtype=torch.int64)):
        with pytest.raises(ValueError) as plain:
            window_ops.window_codes_packed(packed, validbits, 21, R=30,
                                           out=out)
        with pytest.raises(ValueError) as wrapped:
            wck.window_codes_packed_cuda(packed, validbits, 21, R=30,
                                         out=out)
        assert str(wrapped.value) == str(plain.value)
        assert str(plain.value).startswith("out must be")
    with pytest.raises(ValueError, match="contiguous"):
        wck.window_codes_packed_cuda(
            packed, validbits, 21, R=30,
            out=torch.empty(2 * n, dtype=torch.int64)[::2])
    with pytest.raises(ValueError, match="needs 1 <= k <= 31"):
        wck.window_codes_packed_cuda(packed, validbits, 40)


def test_empty_batch_gives_no_slots():
    packed = torch.zeros((0, 8), dtype=torch.uint8)
    validbits = torch.zeros((0, 4), dtype=torch.uint8)
    got = wck.window_codes_packed_cuda(packed, validbits, 21, R=30)
    assert got.shape == (0,) and got.dtype == torch.int64


# ----------------------------------------------------------------------
# the call sites
# ----------------------------------------------------------------------

class _Spy:
    """Stands in for the wrapper at a call site: counts the calls and the
    devices, and runs the real wrapper."""

    def __init__(self):
        self.calls = []

    def __call__(self, packed, validbits, *args, **kw):
        self.calls.append(packed.device.type)
        return wck.window_codes_packed_cuda(packed, validbits, *args, **kw)


def test_ingest_and_counter_step_reach_the_wrapper(fixtures_dir,
                                                   monkeypatch):
    """`counter.ingest` of a packed batch, and so `KmerCounter.step` and
    the CLI's sparse `count`, go through the wrapper; the spectrum is the
    oracle's."""
    spy = _Spy()
    monkeypatch.setattr(counter_mod, "window_codes_packed_cuda", spy)
    packed, validbits, R = _wire("random", 21)
    n = counter_mod.batch_slots((packed, validbits), 21, R)
    out = torch.empty(n, dtype=torch.int64)
    counter_mod.ingest(out, (packed, validbits), 21, True, R)
    assert spy.calls == ["cpu"]
    assert torch.equal(out, window_ops.window_codes_packed(
        packed, validbits, 21, True, R=R))

    spy.calls.clear()
    path = os.path.join(fixtures_dir, "multi.fa")
    cfg = Config(k=21, canonical=True, chunk_len=256, batch_rows=2,
                 sparse_compact_entries=4096, sparse_capacity=1 << 14)
    assert cfg.packed_h2d
    codes, counts = pipeline.count_file(path, cfg, torch.device("cpu"))
    assert len(spy.calls) > 1 and set(spy.calls) == {"cpu"}
    got = {window_ops.code_to_str(int(c), 21): int(n)
           for c, n in zip(codes, counts)}
    assert got == count_fasta_file(path, 21, canonical=True)


def test_filter_step_reaches_the_wrapper(monkeypatch):
    """`filter_device._filter_step` extracts through the wrapper, and its
    bitmap equals the one from the plain version's slots."""
    spy = _Spy()
    monkeypatch.setattr(filter_device, "window_codes_packed_cuda", spy)
    k, B, L = 21, 4, 256
    packed, validbits, R = _wire("random", k, b=B, ln=L)
    codes = window_ops.window_codes_packed(packed, validbits, k, True, R=R)
    valid = codes[codes != window_ops.sentinel(codes.dtype)]
    members = np.unique(valid[::3].numpy()).astype(np.uint64)
    dev = filter_device.DeviceFilter(
        port_filter.FilterSpec(k=k, codes=members, canonical=True),
        batch_rows=B, chunk_len=L, device="cpu")
    got = filter_device._filter_step(dev.members, packed, validbits, k, True,
                                     R, L)
    assert spy.calls == ["cpu"]
    want = filter_device.hit_bitmap(
        filter_device.member_hits(dev.members, codes), B, L)
    assert torch.equal(got, want)
    assert int(got.ne(0).sum()) > 0


# ----------------------------------------------------------------------
# the kernel's source on the host
# ----------------------------------------------------------------------

# the CUDA names window_codes.cu uses, for g++: every block's threads run
# one after another (the kernel has no shared memory and no barrier)
_STUB = r"""
#pragma once
#include <cstdint>
struct stub_dim3 { unsigned x = 0, y = 0, z = 0; };
inline stub_dim3 blockIdx, threadIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
inline unsigned long long __brevll(unsigned long long x) {
  unsigned long long r = 0;
  for (int i = 0; i < 64; ++i) r |= ((x >> i) & 1ull) << (63 - i);
  return r;
}
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  const unsigned long long v = ((unsigned long long)hi << 32) | lo;
  return (unsigned)((v << (s & 31u)) >> 32);
}
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
#define STUB_LAUNCH(grid, block, ...)                                   \
  do {                                                                  \
    gridDim.x = (grid);                                                 \
    blockDim.x = (block);                                               \
    for (blockIdx.x = 0; blockIdx.x < gridDim.x; ++blockIdx.x)          \
      for (threadIdx.x = 0; threadIdx.x < blockDim.x; ++threadIdx.x)    \
        __VA_ARGS__;                                                    \
  } while (0)
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """`fk_window_codes_packed` of csrc/window_codes.cu built by g++ for
    the host (each `<<<grid, block, smem, stream>>>` launch replaced by
    the stub's loop over blocks and threads), loaded with ctypes."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("c1_host")
    (d / "cuda_runtime.h").write_text(_STUB)
    src, n = re.subn(
        r"(window_codes<[^<>]*>)<<<([^,]+), ([^,]+), [^>]*>>>\(([^;]*)\);",
        lambda m: f"STUB_LAUNCH({m.group(2)}, {m.group(3)}, "
                  f"{m.group(1)}({m.group(4)}));",
        SRC.read_text(), flags=re.S)
    assert n == 2  # the fwd and canonical launches
    (d / "window_codes.cpp").write_text(src)
    lib = d / "libc1_host.so"
    res = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fPIC", "-shared", f"-I{d}", "-o",
         str(lib), str(d / "window_codes.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    so = ctypes.CDLL(str(lib))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    so.fk_window_codes_packed.argtypes = [
        p, p, i64, i64, i64, i64, p, ctypes.c_int, ctypes.c_int, p]
    so.fk_window_codes_packed.restype = ctypes.c_int
    return so


def _host_run(so, packed, validbits, k, canonical, R):
    B, nbp = packed.shape
    n = window_ops.packed_slots(B, nbp, k, R)
    out = torch.full((n,), 7, dtype=window_ops.code_dtype(k))
    if n:
        err = so.fk_window_codes_packed(
            packed.data_ptr(), validbits.data_ptr(), B, nbp,
            validbits.shape[1], n // (16 * B), out.data_ptr(), k,
            int(canonical), None)
        assert err == 0
    return out


@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", ALL_KS)
def test_kernel_source_on_host_equals_plain(host_kernel, k, canonical):
    """The kernel's own arithmetic (loads past a row's end, funnel shifts,
    the validity test, the reverse complements, the slot layout) equals
    the plain version slot for slot, including the shifts at k = 16 and
    k >= 29."""
    for case in CASES:
        for b, ln in _geometries(k):
            packed, validbits, R = _wire(case, k, b, ln, seed=1)
            for r in (R, 0, max(R - 5, 1)):
                want = window_ops.window_codes_packed(packed, validbits, k,
                                                      canonical, R=r)
                got = _host_run(host_kernel, packed, validbits, k,
                                canonical, r)
                assert torch.equal(got, want), (case, b, ln, r)


def test_kernel_source_refuses_bad_geometry(host_kernel):
    """k outside 1..31, or more words than the wire holds: the kernel's
    entry returns an error and launches nothing."""
    packed = torch.zeros((2, 8), dtype=torch.uint8)
    validbits = torch.zeros((2, 4), dtype=torch.uint8)
    out = torch.full((64,), 5, dtype=torch.int64)
    for k, nw in ((0, 1), (32, 1), (21, 3)):
        assert host_kernel.fk_window_codes_packed(
            packed.data_ptr(), validbits.data_ptr(), 2, 8, 4, nw,
            out.data_ptr(), k, 0, None) != 0
    assert bool((out == 5).all())


def test_kernel_constants_are_the_wrappers():
    text = SRC.read_text()
    assert int(re.search(r"constexpr int kMaxK = (\d+);", text).group(1)) \
        == window_ops.MAX_K
    assert int(re.search(r"constexpr int kResidues = (\d+);",
                         text).group(1)) == 16


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", [1, 2, 11, 15, 16, 17, 21, 28, 29, 31])
def test_kernel_vs_plain_on_card(k, canonical):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py --only window runs "
                    "this check there")
    for case in CASES:
        for b, ln in _geometries(k) + ((33, 4099),):
            packed, validbits, R = _wire(case, k, b, ln, seed=2)
            p, v = packed.cuda(), validbits.cuda()
            for r in (R, 0, max(R - 5, 1)):
                want = window_ops.window_codes_packed(p, v, k, canonical,
                                                      R=r)
                before = wck.window_codes_packed_cuda.launches
                got = wck.window_codes_packed_cuda(p, v, k, canonical, R=r)
                buf = torch.full((want.numel() + 9,), -3, dtype=want.dtype,
                                 device="cuda")
                wck.window_codes_packed_cuda(p, v, k, canonical, R=r,
                                             out=buf[4 : 4 + want.numel()])
                torch.cuda.synchronize()
                assert wck.window_codes_packed_cuda.launches == before + (
                    2 if want.numel() else 0)
                assert got.dtype == want.dtype
                assert torch.equal(got, want), (case, b, ln, r)
                assert torch.equal(buf[4 : 4 + want.numel()], want)
                assert bool((buf[:4] == -3).all() and (buf[-5:] == -3).all())
