"""K2, the fused window histogram: its plain versions, its wrappers on the
CPU, and the kernel's partition of windows into per-thread runs.

The same numpy-seeded rows go through the JAX `fused_window_histogram`
(the Pallas kernel in interpret mode, as tests/test_pallas.py runs it),
the port's plain version of the rows entry, the plain version of the wire
entry on the same rows packed by the port's host packer, and both CUDA
wrappers on CPU tensors.  Counts are integers: equality is exact.

The kernel itself runs only on a CUDA card (the `cuda` tests at the end;
`chip_smoke.py` holds it against the plain version at the production
shape).  Here its walk is replayed in numpy with the arithmetic of
`csrc/window_histogram.cu` and `csrc/bins.cuh`: the aligned 16-byte loads
at any misalignment, a run of kRun bases and its halo in registers, codes
and reverse complements by funnel shifts, the mask of valid windows, the
summing of equal consecutive codes before each add, and the 16-bit bins
with their carries.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findkmer_tpu.ops.pallas.histogram_kernel import fused_window_histogram
from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda import window_histogram_kernel as wk
from findkmer_torch.pipeline import _numpy_pack_rows

torch.set_num_threads(1)  # six test workers share the cores

KS = [1, 4, 5, 6, 8, 9, 10]
B, L = 6, 50  # tests/test_pallas.py's odd geometry
SRC = pathlib.Path(__file__).resolve().parents[1] / "findkmer_torch" / "csrc"


def _const(name):
    """A `constexpr int` of the kernel's sources."""
    text = ((SRC / "window_histogram.cu").read_text()
            + (SRC / "bins.cuh").read_text())
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


K_RUN = _const("kRun")
K_LOAD_HALO = _const("kLoadHalo")
WORD_MAX_K = _const("kWordMaxK")
SHARED_MAX_K = _const("kSharedMaxK")
HALF_BINS_LOG2 = _const("kHalfBinsLog2")


def _batch(k, case="random", seed=None, b=B, ln=L):
    """(rows (b, R), packed, validbits, R) of one batch cut from a flat
    stream the way the host batcher cuts it: row i = work[i*L : i*L + R],
    R = L + k - 1, packed by the port's numpy packer."""
    rng = np.random.default_rng(k if seed is None else seed)
    R = ln + k - 1
    halo = k - 1
    n = halo + b * ln
    if case == "random":
        work = rng.integers(0, 4, n).astype(np.uint8)
        bad = rng.random(n) < 0.02
        # invalid bytes: INVALID itself and anything from 5 to 255
        work[bad] = rng.choice([4, 5, 77, 255], bad.sum()).astype(np.uint8)
    elif case == "invalid":
        work = rng.integers(4, 256, n).astype(np.uint8)
    elif case == "poly_a":
        work = np.zeros(n, np.uint8)
    else:
        raise ValueError(case)
    rows = np.stack([work[i * ln : i * ln + R] for i in range(b)])
    R8 = (R + 7) // 8 * 8
    packed, validbits = _numpy_pack_rows(work, b, ln, R, R8)
    return rows, packed, validbits, R


@pytest.fixture(scope="module")
def jax_hists():
    """(k, canonical) -> the JAX fused_window_histogram of _batch(k)."""
    out = {}
    for k in KS:
        rows = jnp.asarray(_batch(k)[0])
        for canonical in (False, True):
            out[k, canonical] = np.asarray(fused_window_histogram(
                rows, k, canonical=canonical, interpret=True))
    return out


@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", KS)
def test_plain_versions_and_cpu_wrappers_vs_jax(jax_hists, k, canonical):
    rows, packed, validbits, R = _batch(k)
    assert R % 8  # the wire's last byte holds padding slots past R
    want = jax_hists[k, canonical]
    assert want.shape == (4 ** k,) and want.sum() > 0
    t_rows = torch.from_numpy(rows)
    t_packed, t_valid = torch.from_numpy(packed), torch.from_numpy(validbits)
    before = wk.fused_window_histogram_cuda.launches
    for got in (
        wk.fused_window_histogram_reference(t_rows, k, canonical),
        wk.fused_window_histogram_packed_reference(
            t_packed, t_valid, k, canonical, R),
        wk.fused_window_histogram_cuda(t_rows, k, canonical),
        wk.fused_window_histogram_packed_cuda(
            t_packed, t_valid, k, canonical, R),
    ):
        assert got.dtype == torch.int32 and got.shape == (4 ** k,)
        np.testing.assert_array_equal(got.numpy(), want)
    assert wk.fused_window_histogram_cuda.launches == before  # no launch


@pytest.mark.parametrize("case", ["invalid", "poly_a"])
@pytest.mark.parametrize("k", [1, 4, 8, 10])
def test_all_invalid_and_hot_bin(k, case):
    rows, packed, validbits, R = _batch(k, case)
    want = np.asarray(fused_window_histogram(jnp.asarray(rows), k,
                                             interpret=True))
    if case == "invalid":
        assert want.sum() == 0
    else:
        assert want[0] == B * L and want.sum() == B * L  # one hot bin
    for canonical in (False, True):
        np.testing.assert_array_equal(
            wk.fused_window_histogram_cuda(
                torch.from_numpy(rows), k, canonical).numpy(), want)
        np.testing.assert_array_equal(
            wk.fused_window_histogram_packed_cuda(
                torch.from_numpy(packed), torch.from_numpy(validbits), k,
                canonical, R).numpy(), want)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_row_of_exactly_k_bases_and_shorter(k):
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 4, (3, k)).astype(np.uint8)
    for canonical in (False, True):
        codes, _ = window_ops.window_codes(torch.from_numpy(rows), k,
                                           canonical)
        want = np.bincount(codes.numpy().ravel(), minlength=4 ** k)
        got = wk.fused_window_histogram_cuda(torch.from_numpy(rows), k,
                                             canonical)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == 3  # one window a row
        short = wk.fused_window_histogram_cuda(
            torch.from_numpy(rows[:, : k - 1].copy()), k, canonical)
        assert int(short.abs().sum()) == 0 and short.shape == (4 ** k,)


# ----------------------------------------------------------------------
# the kernel's walk, replayed
# ----------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on arrays of 32-bit words (held in uint64)."""
    both = (x & M32) | ((y & M32) << np.uint64(32))
    out = np.zeros_like(both)
    for j in range(4):
        src = (sel >> (4 * j)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) \
            << np.uint64(8 * j)
    return out


def _brev(x):
    out = np.zeros_like(x)
    for j in range(32):
        out |= ((x >> np.uint64(j)) & np.uint64(1)) << np.uint64(31 - j)
    return out


def _bit_order(x):
    return _byte_perm(_brev(x), np.zeros_like(x), 0x0123)


class _Memory:
    """A tensor's bytes at an address of any alignment, with foreign bytes
    around them, and a record of every 16-byte unit that was read."""

    def __init__(self, data, org, rng):
        self.begin = 64 + org
        self.end = self.begin + data.size
        self.mem = rng.integers(0, 256, self.end + 64 + 16).astype(np.uint8)
        self.mem[self.begin : self.end] = data.ravel()
        self.units = set()


def _load_words(memory, p, nw):
    """`load_words` of window_histogram.cu for an array of addresses p ->
    (len(p), nw) words."""
    nq = (4 * nw + 15 + 15) // 16
    m = p & 15
    q = p - m
    a = np.zeros((p.size, 4 * nq + 3), np.uint64)
    for i in range(nq):
        u = q + 16 * i
        cond = ((16 * i < m + 4 * nw) & (u + 16 > memory.begin)
                & (u < memory.end))
        assert (u[cond] % 16 == 0).all()
        memory.units.update(u[cond].tolist())
        idx = np.where(cond, u, 0)[:, None] + np.arange(16)
        words = np.ascontiguousarray(memory.mem[idx]).view("<u4")
        a[:, 4 * i : 4 * i + 4] = np.where(cond[:, None], words, 0)
    bits = (8 * (m & 3)).astype(np.uint64)
    for j in range(4 * nq):  # __funnelshift_r(a[j], a[j + 1], bits)
        a[:, j] = ((a[:, j] | (a[:, j + 1] << np.uint64(32))) >> bits) & M32
    for j in range(4 * nq):
        a[:, j] = np.where(m & 4, a[:, j + 1], a[:, j])
    return np.stack([np.where(m & 8, a[:, j + 2], a[:, j])
                     for j in range(nw)], axis=1)


def _funnel_r(lo, hi, shift):
    """CUDA's __funnelshift_r: bits shift .. shift + 31 of hi:lo."""
    return (((lo & M32) | ((hi & M32) << np.uint64(32)))
            >> np.uint64(shift)) & M32


def _funnel_l(lo, hi, shift):
    """CUDA's __funnelshift_l: the high word of hi:lo << shift."""
    return ((((lo & M32) | ((hi & M32) << np.uint64(32)))
             << np.uint64(shift)) >> np.uint64(32)) & M32


def _reverse_bases(x):
    y = _brev(x)
    return (((y & 0x55555555) << np.uint64(1))
            | ((y >> np.uint64(1)) & 0x55555555)) & M32


NW16 = (K_LOAD_HALO + K_RUN) // 16  # words of 16 bases a run


class _Runs:
    """`Run` for every run at once: fwd and rev (NW16 words), valid (3)."""

    def clip_valid(self, c, R):
        v = self.valid
        v[0] = np.where(c == 0, v[0] & (M32 ^ ((1 << K_LOAD_HALO) - 1)), v[0])
        left = R - c * K_RUN
        n = np.where(left < K_RUN, left + K_LOAD_HALO, 96)
        for j in range(3):
            keep = np.clip(n - 32 * j, 0, 32).astype(np.uint64)
            v[j] = v[j] & ((np.uint64(1) << keep) - np.uint64(1))


class _RowsRuns(_Runs):
    """RowsSource::load."""

    def __init__(self, rows, org, rng):
        self.B, self.R = rows.shape
        self.memory = _Memory(rows, org, rng)

    def load(self, row, c):
        nw = (K_LOAD_HALO + K_RUN) // 4
        p = self.memory.begin + row * self.R + c * K_RUN - K_LOAD_HALO
        w = _load_words(self.memory, p, nw)
        self.rev = [np.zeros(p.size, np.uint64) for _ in range(NW16)]
        self.valid = [np.zeros(p.size, np.uint64) for _ in range(3)]
        for j in range(nw):
            t = w[:, j] & 0x03030303
            t = (t | (t >> np.uint64(6))) & 0x000F000F
            t = (t | (t >> np.uint64(12))) & 0xFF
            self.rev[j // 4] |= t << np.uint64(8 * (j % 4))
            z = w[:, j] & 0xFCFCFCFC
            bad = ((((z & 0x7F7F7F7F) + 0x7F7F7F7F) & M32) | z) \
                >> np.uint64(7)
            nib = ((((bad & 0x01010101) * 0x01020408) & M32)
                   >> np.uint64(24)) ^ 0xF
            assert (nib < 16).all()
            self.valid[j // 8] |= nib << np.uint64(4 * (j % 8))
        self.fwd = [_reverse_bases(x) for x in self.rev]
        self.clip_valid(c, self.R)


class _PackedRuns(_Runs):
    """PackedSource::load."""

    def __init__(self, packed, validbits, R, org, rng):
        self.B, self.nbp = packed.shape
        self.nbv = validbits.shape[1]
        self.R = R
        self.memory = _Memory(packed, org, rng)
        self.vmemory = _Memory(validbits, (org * 7 + 3) % 16, rng)

    def load(self, row, c):
        p = (self.memory.begin + row * self.nbp + c * (K_RUN // 4)
             - K_LOAD_HALO // 4)
        w = _load_words(self.memory, p, NW16)
        zero = np.zeros(p.size, np.uint64)
        self.fwd = [_byte_perm(w[:, j], zero, 0x0123) for j in range(NW16)]
        self.rev = [_reverse_bases(x) for x in self.fwd]
        pv = (self.vmemory.begin + row * self.nbv + c * (K_RUN // 8)
              - K_LOAD_HALO // 8)
        x = _load_words(self.vmemory, pv, 3)
        self.valid = [_bit_order(x[:, 0]), _bit_order(x[:, 1]),
                      _bit_order(x[:, 2]) & 0xFFFF]
        self.clip_valid(c, self.R)


def _replay(source, k, canonical):
    """The kernel's threads, all at once: thread g owns the windows that
    end in run g % runs_per_row of row g // runs_per_row.  Returns (how
    many times each (row, window) was binned, the adds as (code, n) in the
    order of the threads)."""
    nrows, R = source.B, source.R
    W = R - k + 1
    binned = np.zeros((nrows, max(W, 0)), np.int64)
    if nrows == 0 or W <= 0:  # the launch returns before the kernel
        return binned, []
    rpr = -(-R // K_RUN)
    g = np.arange(nrows * rpr)
    row, c = g // rpr, g % rpr
    source.load(row, c)
    mask = (1 << (2 * k)) - 1
    ends = list(source.valid)
    cover = 1
    while cover < k:
        s = cover if 2 * cover <= k else k - cover
        ends[2] = ends[2] & _funnel_l(ends[1], ends[2], s)
        ends[1] = ends[1] & _funnel_l(ends[0], ends[1], s)
        ends[0] = ends[0] & ((ends[0] << np.uint64(s)) & M32)
        cover += s
    sh = 2 * (k - 1)  # RcStream
    inv = [x ^ M32 for x in source.rev]
    zero = np.zeros(g.size, np.uint64)
    rcs = [(inv[0] << np.uint64(sh)) & M32]
    rcs += [_funnel_l(inv[j - 1], inv[j], sh) for j in range(1, NW16)]
    rcs.append(_funnel_l(inv[NW16 - 1], zero, sh))
    held = np.zeros(g.size, np.int64)
    held_n = np.zeros(g.size, np.int64)
    adds = []

    def add(sel):
        adds.extend(zip(held[sel].tolist(), held_n[sel].tolist()))

    for i in range(K_LOAD_HALO, K_LOAD_HALO + K_RUN):
        hit = ((ends[i >> 5] >> np.uint64(i & 31)) & 1) == 1
        cc = _funnel_r(source.fwd[i >> 4], source.fwd[(i >> 4) - 1],
                       30 - 2 * (i & 15)) & mask
        if canonical:
            rc = _funnel_r(rcs[i >> 4], rcs[(i >> 4) + 1], 2 * (i & 15)) & mask
            cc = np.minimum(cc, rc)
        cc = cc.astype(np.int64)
        ends_at = c[hit] * K_RUN + i - K_LOAD_HALO  # the window's last base
        np.add.at(binned, (row[hit], ends_at - k + 1), 1)
        same = hit & (cc == held)
        held_n[same] += 1
        new = hit & ~same
        add(new & (held_n > 0))
        held[new], held_n[new] = cc[new], 1
    add(held_n > 0)
    return binned, adds


def _word_bins(adds, k):
    hist = np.zeros(4 ** k, np.int64)
    for code, n in adds:
        hist[code] += n
    return hist


def _half_bins(adds, k, order=None):
    """bins.cuh's HalfBins for one block a part: every add as one atomic
    on a 32-bit word of two 16-bit bins that returns the old word, wraps
    carried to the global table at once, then the flush."""
    out = np.zeros(4 ** k, np.int64)
    parts = 4 ** k >> HALF_BINS_LOG2
    order = range(len(adds)) if order is None else order
    for part in range(parts):
        base = part << HALF_BINS_LOG2
        words = np.zeros(1 << (HALF_BINS_LOG2 - 1), np.uint64)
        for e in order:
            code, n = adds[e]
            assert 0 < n < 65536
            if code >> HALF_BINS_LOG2 != part:
                continue
            b = code & ((1 << HALF_BINS_LOG2) - 1)
            addend = n << (16 * (b & 1))
            old = int(words[b >> 1])
            words[b >> 1] = (old + addend) & M32
            if not b & 1 and (old & 0xFFFF) + n > 0xFFFF:
                out[base + b] += 65536
                out[base + b + 1] -= 1
            if old + addend > M32:
                out[base + (b | 1)] += 65536
        out[base : base + (1 << HALF_BINS_LOG2) : 2] += (
            words & np.uint64(0xFFFF)).astype(np.int64)
        out[base + 1 : base + (1 << HALF_BINS_LOG2) : 2] += (
            words >> np.uint64(16)).astype(np.int64)
    return out


def _bins(adds, k):
    """The private bins the kernel has for this k (global bins count as
    the int32 ones do)."""
    if WORD_MAX_K < k <= SHARED_MAX_K:
        return _half_bins(adds, k)
    return _word_bins(adds, k)


@pytest.mark.parametrize("org", [0, 2, 7, 13])
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", [1, 4, 6, 7, 8, 9, 10])
def test_kernel_walk_bins_every_window_once(k, canonical, org):
    """Every valid window of every row is binned exactly once, no invalid
    one is, and the histogram equals the plain version's, through both
    sources of bases, with the tensors at addresses of any alignment
    (rows of the wire start at odd bytes besides), ragged row tails, and
    only 16-byte units read that hold a byte of the tensor."""
    rows, packed, validbits, R = _batch(k, seed=100 + k, b=5, ln=170)
    assert packed.shape[1] % 16  # rows start off the 16-byte grid
    _, valid = window_ops.window_codes(torch.from_numpy(rows), k)
    want = wk.fused_window_histogram_reference(
        torch.from_numpy(rows), k, canonical).numpy()
    rng = np.random.default_rng(k + org)
    for source in (_RowsRuns(rows, org, rng),
                   _PackedRuns(packed, validbits, R, org, rng)):
        binned, adds = _replay(source, k, canonical)
        np.testing.assert_array_equal(binned, valid.numpy().astype(np.int64))
        np.testing.assert_array_equal(_bins(adds, k), want)
        mem = source.memory
        assert all(mem.begin - 16 < u < mem.end for u in mem.units)


@pytest.mark.parametrize("m", range(16))
def test_load_words_at_every_misalignment(m):
    """`load_words` returns the bytes at p .. p + 4 NW - 1 whatever p's
    alignment, zeros for whole 16-byte units outside the tensor, and reads
    no unit that holds no byte of the tensor."""
    rng = np.random.default_rng(m)
    data = rng.integers(0, 256, 200).astype(np.uint8)
    for nw in (3, 5, 20):
        memory = _Memory(data, m, rng)
        offs = np.array([-16, -4, -2, 0, 16, 48, 100, 200 - 4 * nw,
                         200 - 4, 190])
        got = _load_words(memory, memory.begin + offs, nw)
        for o, words in zip(offs.tolist(), got):
            raw = words.astype("<u4").tobytes()
            for j in range(4 * nw):
                addr = memory.begin + o + j
                if memory.begin <= addr < memory.end:
                    assert raw[j] == data[o + j], (nw, o, j)
                else:  # a neighbour's byte or nothing: never a fault
                    unit = addr - addr % 16
                    inside = (unit + 16 > memory.begin and unit < memory.end)
                    assert inside or raw[j] == 0
        assert all(memory.begin - 16 < u < memory.end for u in memory.units)


@pytest.mark.parametrize("case", [
    "low_hot", "high_hot", "both_hot", "carry_wraps_word", "random",
])
def test_half_bins_carries_and_wraps_are_exact(case):
    """The packed 16-bit bins under shuffled orders of the atomics: a
    poly-A hot bin far above 65,535 in the low half, in the high half, in
    both halves of one word, a carry out of the low half that makes the
    word itself wrap, and random codes."""
    k = 8
    rng = np.random.default_rng(len(case))
    if case == "low_hot":
        adds = [(0, 64)] * 3000 + [(1, 1)] * 10
    elif case == "high_hot":
        adds = [(65535, 64)] * 3000 + [(65534, 3)] * 7
    elif case == "both_hot":
        adds = [(10, 64)] * 2500 + [(11, 63)] * 2500 + [(10, 1)] * 999
    elif case == "carry_wraps_word":
        # the high half stands at 65,535 when a low wrap carries into it
        adds = [(21, 65535)] + [(20, 4096)] * 16 + [(20, 64)] * 1100
    else:
        adds = [(int(c), int(n)) for c, n in zip(
            rng.integers(0, 4 ** k, 5000), rng.integers(1, 65, 5000))]
    want = _word_bins(adds, k)
    assert case == "random" or want.max() > 65535
    for _ in range(4):
        order = rng.permutation(len(adds))
        np.testing.assert_array_equal(_half_bins(adds, k, order), want)


@pytest.mark.parametrize("k", [8, 9])
def test_half_bins_every_code_has_one_owner(k):
    """The parts by the top bits of the code: each of the 4^k codes is
    binned by exactly one part, into its own bin."""
    codes = np.arange(4 ** k)
    parts = 4 ** k >> HALF_BINS_LOG2
    assert parts == (1 if k == 8 else 4)
    owners = sum((codes >> HALF_BINS_LOG2 == p).astype(int)
                 for p in range(parts))
    assert (owners == 1).all()
    adds = [(int(c), 1) for c in codes[:: 4 ** k // 4096]] + [(4 ** k - 1, 5)]
    np.testing.assert_array_equal(_half_bins(adds, k), _word_bins(adds, k))


def test_kernel_walk_sums_homopolymer_runs():
    """A poly-A row costs one atomic per thread, not one per window; a
    random row about one per window."""
    k, nrows, ln = 8, 2, 4 * K_RUN
    rng = np.random.default_rng(0)
    rows, _, _, R = _batch(k, "poly_a", b=nrows, ln=ln)
    _, adds = _replay(_RowsRuns(rows, 0, rng), k, False)
    assert _word_bins(adds, k)[0] == nrows * ln
    assert len(adds) == nrows * -(-R // K_RUN)  # one a run of 64 bases
    rows, _, _, R = _batch(k, b=nrows, ln=ln)
    _, adds = _replay(_RowsRuns(rows, 0, rng), k, False)
    assert len(adds) > 0.9 * _word_bins(adds, k).sum()


def test_kernel_walk_short_rows():
    rng = np.random.default_rng(0)
    for R in (0, 3, 4):
        rows = np.zeros((2, R), np.uint8)
        binned, adds = _replay(_RowsRuns(rows, 5, rng), 4, False)
        assert _word_bins(adds, 4).sum() == (2 if R == 4 else 0)


@pytest.mark.parametrize("k,windows,want", [
    (1, 1, True), (6, 1, True), (6, 10 ** 9, True),
    (7, 64 * 4 ** 7 - 1, False), (7, 64 * 4 ** 7, True),
    (8, 4993, False), (8, 64 * 4 ** 8 - 1, False), (8, 64 * 4 ** 8, True),
    (8, 1024 * 65536, True), (9, 1024 * 65536, True),
    (9, 64 * 4 ** 9 - 1, False), (10, 1024 * 65536, False),
])
def test_private_bins_threshold(k, windows, want):
    """Which bins the wrappers take: private always for k <= 6, from 64
    windows a bin for k = 7..9 (a record of 5000 bases stays on the global
    table, a production batch does not), never at k = 10."""
    from findkmer_torch.ops.cuda import histogram_kernel as hk

    assert hk.private_bins(k, windows) is want


def test_wrapper_constants_are_the_kernels():
    from findkmer_torch.ops.cuda import histogram_kernel as hk

    assert hk.SHARED_MAX_K == SHARED_MAX_K and hk.MAX_K == _const("kMaxK")
    assert K_LOAD_HALO >= hk.MAX_K - 1  # the halo holds k - 1 bases
    assert K_RUN % 32 == 0 and K_LOAD_HALO % 16 == 0
    assert 4 ** WORD_MAX_K * 4 <= 227 * 1024  # a block's shared memory
    assert (1 << HALF_BINS_LOG2) * 2 <= 227 * 1024
    assert 4 ** SHARED_MAX_K >> HALF_BINS_LOG2 in (1, 4)
    with pytest.raises(ValueError, match="private"):
        wk.fused_window_histogram_cuda(
            torch.zeros((1, 12), dtype=torch.uint8), 10, private=True)


# ----------------------------------------------------------------------
# arguments
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    "k0", "k11", "int8", "bool", "1d", "strided", "meta",
])
def test_rows_entry_rejects_bad_input(bad):
    rows = torch.zeros((4, 20), dtype=torch.uint8)
    k = 4
    if bad == "k0":
        k = 0
    elif bad == "k11":
        k = 11
    elif bad == "int8":
        rows = rows.to(torch.int8)
    elif bad == "bool":
        rows = rows.bool()
    elif bad == "1d":
        rows = rows.reshape(-1)
    elif bad == "strided":
        rows = rows[:, ::2]
    elif bad == "meta":
        rows = rows.to("meta")
    with pytest.raises((ValueError, TypeError)):
        wk.fused_window_histogram_cuda(rows, k)


@pytest.mark.parametrize("bad", [
    "k11", "packed_int32", "rows_mismatch", "widths", "R_too_long",
    "R_negative", "strided", "devices",
])
def test_wire_entry_rejects_bad_input(bad):
    packed = torch.zeros((4, 6), dtype=torch.uint8)
    validbits = torch.zeros((4, 3), dtype=torch.uint8)
    k, R = 4, 21
    if bad == "k11":
        k = 11
    elif bad == "packed_int32":
        packed = packed.int()
    elif bad == "rows_mismatch":
        validbits = validbits[:3]
    elif bad == "widths":
        validbits = torch.zeros((4, 4), dtype=torch.uint8)
    elif bad == "R_too_long":
        R = 25
    elif bad == "R_negative":
        R = -1
    elif bad == "strided":
        packed = torch.zeros((4, 12), dtype=torch.uint8)[:, ::2]
    elif bad == "devices":
        validbits = validbits.to("meta")
    with pytest.raises((ValueError, TypeError)):
        wk.fused_window_histogram_packed_cuda(packed, validbits, k, False, R)


def test_add_window_counts_adds_in_place_int32_and_int64():
    k = 5
    rows, packed, validbits, R = _batch(k, seed=9)
    want = wk.fused_window_histogram_reference(
        torch.from_numpy(rows), k, True).numpy()
    for dtype in (torch.int32, torch.int64):
        base = torch.full((4 ** k,), (1 << 33) if dtype == torch.int64
                          else 7, dtype=dtype)
        for batch in (torch.from_numpy(rows),
                      (torch.from_numpy(packed), torch.from_numpy(validbits))):
            table = base.clone()
            got = wk.add_window_counts_cuda(batch, table, k, True, R)
            assert got is table and table.dtype == dtype
            np.testing.assert_array_equal(table.numpy(),
                                          base.numpy() + want)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", [1, 2, 4, 6, 7, 8, 9, 10])
def test_kernel_vs_plain_on_card(k, canonical):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    for case in ("random", "invalid", "poly_a"):
        rows, packed, validbits, R = _batch(k, case, b=33, ln=4099)
        r = torch.from_numpy(rows).cuda()
        p, v = torch.from_numpy(packed).cuda(), torch.from_numpy(
            validbits).cuda()
        want = wk.fused_window_histogram_reference(r, k, canonical)
        for private in (None, False) + ((True,) if k <= SHARED_MAX_K else ()):
            before = wk.fused_window_histogram_cuda.launches
            got_rows = wk.fused_window_histogram_cuda(r, k, canonical,
                                                      private=private)
            got_wire = wk.fused_window_histogram_packed_cuda(
                p, v, k, canonical, R, private=private)
            torch.cuda.synchronize()
            assert wk.fused_window_histogram_cuda.launches == before + 2
            assert torch.equal(got_rows, want), (case, private)
            assert torch.equal(got_wire, want), (case, private)
        table = torch.full_like(want, 3)
        assert wk.add_window_counts_cuda((p, v), table, k, canonical,
                                         R) is table
        assert torch.equal(table, want + 3), case
