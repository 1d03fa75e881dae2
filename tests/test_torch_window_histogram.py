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
`csrc/window_histogram.cu`: runs of kRun windows per thread, the k-1 halo
bases, the rolling code, reverse complement and valid-run count, and the
summing of equal consecutive codes before each add.
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
K_RUN = int(re.search(r"constexpr int kRun = (\d+);",
                      (SRC / "window_histogram.cu").read_text()).group(1))


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

def _rows_source(rows):
    def at(row, p):
        c = rows[row, p].astype(np.int64)
        return c & 3, c < 4
    return at


def _packed_source(packed, validbits):
    def at(row, p):
        w = packed[row, p >> 2].astype(np.int64)
        v = validbits[row, p >> 3].astype(np.int64)
        return (w >> (6 - 2 * (p & 3))) & 3, ((v >> (7 - (p & 7))) & 1) == 1
    return at


def _replay(at, nrows, R, k, canonical, run):
    """The kernel's threads, all at once: thread g owns windows
    [first, end) of row g // NR.  Returns (histogram, how many times each
    (row, window) was binned, atomics issued)."""
    W = R - k + 1
    hist = np.zeros(4 ** k, np.int64)
    binned = np.zeros((nrows, max(W, 0)), np.int64)
    if W <= 0:
        return hist, binned, 0
    nr = -(-W // run)
    g = np.arange(nrows * nr)
    row, first = g // nr, (g % nr) * run
    end = np.minimum(first + run, W)
    mask, shift = (1 << (2 * k)) - 1, 2 * (k - 1)
    code = np.zeros(g.size, np.int64)
    rc = np.zeros(g.size, np.int64)
    vrun = np.zeros(g.size, np.int64)
    held = np.zeros(g.size, np.int64)
    held_n = np.zeros(g.size, np.int64)
    atomics = 0

    def add(sel):
        nonlocal atomics
        np.add.at(hist, held[sel], held_n[sel])
        atomics += int(sel.sum())

    for j in range(run + k - 1):
        p = first + j
        live = p < end + k - 1  # bases first .. end + k - 2
        b, v = at(row[live], p[live])
        code[live] = ((code[live] << 2) | b) & mask
        if canonical:
            rc[live] = (rc[live] >> 2) | ((3 - b) << shift)
        vrun[live] = np.where(v, vrun[live] + 1, 0)
        hit = live & (vrun >= k)
        c = np.minimum(code, rc) if canonical else code
        np.add.at(binned, (row[hit], p[hit] - k + 1), 1)
        same = hit & (c == held) & (held_n > 0)
        held_n[same] += 1
        new = hit & ~same
        add(new & (held_n > 0))
        held[new], held_n[new] = c[new], 1
    add(held_n > 0)
    return hist, binned, atomics


@pytest.mark.parametrize("run", sorted({K_RUN, 1, 3, 16}))
@pytest.mark.parametrize("canonical", [False, True], ids=["fwd", "canon"])
@pytest.mark.parametrize("k", [1, 4, 6, 9, 10])
def test_kernel_walk_bins_every_window_once(k, canonical, run):
    """Every valid window of every row is binned exactly once, no invalid
    one is, and the histogram equals the plain version's, through both
    sources of bases, at the kernel's run length and at short ones that
    put many run boundaries (and halos) in a small batch."""
    rows, packed, validbits, R = _batch(k, seed=100 + k, b=5, ln=170)
    _, valid = window_ops.window_codes(torch.from_numpy(rows), k)
    want = wk.fused_window_histogram_reference(
        torch.from_numpy(rows), k, canonical).numpy()
    for at in (_rows_source(rows), _packed_source(packed, validbits)):
        hist, binned, _ = _replay(at, rows.shape[0], R, k, canonical, run)
        np.testing.assert_array_equal(binned, valid.numpy().astype(np.int64))
        np.testing.assert_array_equal(hist, want)


def test_kernel_walk_sums_homopolymer_runs():
    """A poly-A row costs one atomic per thread, not one per window; a
    random row about one per window."""
    k, nrows, ln = 8, 2, 4 * K_RUN
    rows, _, _, R = _batch(k, "poly_a", b=nrows, ln=ln)
    hist, _, atomics = _replay(_rows_source(rows), nrows, R, k, False, K_RUN)
    assert hist[0] == nrows * ln and atomics == nrows * ln // K_RUN
    rows, _, _, R = _batch(k, b=nrows, ln=ln)
    hist, _, atomics = _replay(_rows_source(rows), nrows, R, k, False, K_RUN)
    assert atomics > 0.9 * hist.sum()


def test_kernel_walk_short_rows():
    for R in (0, 3, 4):
        rows = np.zeros((2, R), np.uint8)
        hist, binned, atomics = _replay(_rows_source(rows), 2, R, 4, False,
                                        K_RUN)
        assert hist.sum() == (2 if R == 4 else 0)


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
@pytest.mark.parametrize("k", [1, 2, 4, 6, 7, 8, 10])
def test_kernel_vs_plain_on_card(k, canonical):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    for case in ("random", "invalid", "poly_a"):
        rows, packed, validbits, R = _batch(k, case, b=33, ln=4099)
        r = torch.from_numpy(rows).cuda()
        p, v = torch.from_numpy(packed).cuda(), torch.from_numpy(
            validbits).cuda()
        want = wk.fused_window_histogram_reference(r, k, canonical)
        before = wk.fused_window_histogram_cuda.launches
        got_rows = wk.fused_window_histogram_cuda(r, k, canonical)
        got_wire = wk.fused_window_histogram_packed_cuda(p, v, k, canonical,
                                                         R)
        torch.cuda.synchronize()
        assert wk.fused_window_histogram_cuda.launches == before + 2
        assert torch.equal(got_rows, want), case
        assert torch.equal(got_wire, want), case
