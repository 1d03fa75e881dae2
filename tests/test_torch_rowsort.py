"""K3, the row sort of the sparse store: its plain version, its wrapper
on the CPU, and the kernel's compare-exchange network.

The kernel itself runs only on a CUDA card (the `cuda` tests at the end;
`chip_smoke.py` holds it against the plain version at the production
shapes).  Here its schedule is replayed in numpy, phase by phase with the
index arithmetic of `csrc/rowsort.cu`: the home layout's register and
shuffle stages, the column layouts between shared-memory transposes, the
global passes of rows longer than a tile, including the slots past C that
act as +infinity; keys are integers, so every check is exact.
"""

import numpy as np
import pytest
import torch

from findkmer_torch.ops.cuda import rowsort_kernel as rk

torch.set_num_threads(1)  # six test workers share the cores

SHAPES = [(3, 1000), (64, 64), (5, 1), (4, 2), (7, 33), (2, 1537)]


def _keys(shape, dtype, case, seed=0):
    rng = np.random.default_rng(seed)
    G, C = shape
    mx = np.iinfo(dtype).max
    if case == "random":
        return rng.integers(0, 50, shape).astype(dtype)  # many ties
    if case == "equal":
        return np.full(shape, 7, dtype)
    if case == "sentinel":
        return np.full(shape, mx, dtype)
    if case == "sorted":
        return np.tile(np.arange(C, dtype=dtype), (G, 1))
    if case == "reversed":
        return np.tile(np.arange(C, 0, -1).astype(dtype), (G, 1))
    keys = rng.integers(-(1 << 20), 1 << 20, shape).astype(dtype)
    keys[rng.random(shape) < 0.3] = mx  # "mixed": negatives and sentinels
    return keys


CASES = ["random", "equal", "sentinel", "sorted", "reversed", "mixed"]


def _pairs_equal(k1, v1, k2, v2):
    """Same keys row by row, and the same (key, val) multiset per row."""
    np.testing.assert_array_equal(k1, k2)
    for r in range(k1.shape[0]):
        a = sorted(zip(k1[r].tolist(), v1[r].tolist()))
        b = sorted(zip(k2[r].tolist(), v2[r].tolist()))
        assert a == b


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kd", [np.int32, np.int64])
def test_sort_rows_reference_vs_numpy(kd, case):
    for shape in SHAPES:
        keys = _keys(shape, kd, case)
        vals = np.arange(keys.size, dtype=np.int64).reshape(shape)
        gk, gv = rk.sort_rows_reference(torch.from_numpy(keys),
                                        torch.from_numpy(vals))
        order = np.argsort(keys, axis=1, kind="stable")
        _pairs_equal(gk.numpy(), gv.numpy(), np.sort(keys, axis=1),
                     np.take_along_axis(vals, order, 1))
        k_only, none = rk.sort_rows_reference(torch.from_numpy(keys))
        assert none is None
        np.testing.assert_array_equal(k_only.numpy(), np.sort(keys, axis=1))


# ---- the kernel's schedule, replayed ----------------------------------------
#
# `csrc/rowsort.cu` holds 8 slots a thread in registers and names layouts:
# which slot register r of thread t holds.  The functions below repeat its
# index arithmetic (same names, same formulas); `_tile_schedule` lists the
# kernel's phases in order, each stage as the partner arithmetic the kernel
# uses there (a register of the same thread, or a register of the lane
# `lane ^ lmask`), and `_stage_pairs` turns a stage into (lower slot, upper
# slot) pairs through the layout.  The tests check that these pairs are the
# network's, that every slot has exactly one owner and one partner per stage,
# and that running them sorts.

LOG_E = 3
E = 1 << LOG_E
LOG_WARP = 5 + LOG_E
MAX_LOG_TILE = 12
SEAMS = [1, 2, 7, 8, 9, 255, 256, 257, 1023, 1025, 2047, 2049, 4096, 4097]


def flip_rmask(L, LV):
    vb = min(L, LV)
    qb = L - LV - 5 if L > LV + 5 else 0
    return ((1 << vb) - 1) | (((1 << qb) - 1) << LV)


def flip_lmask(L, LV):
    lb = 0 if L <= LV else min(L - LV, 5)
    return (1 << lb) - 1


def stride_rmask(B, LV):
    return 1 << B if B < LV else (1 << (B - 5) if B >= LV + 5 else 0)


def stride_lmask(B, LV):
    return 1 << (B - LV) if LV <= B < LV + 5 else 0


def home_slot(t, r, LV):
    return (((t >> 5) << LOG_WARP) | ((r >> LV) << (5 + LV))
            | ((t & 31) << LV) | (r & ((1 << LV) - 1)))


def col_slot(t, r, LB, mirror):
    low_mask = (1 << LB) - 1
    low = t & low_mask
    if mirror:
        low = np.where(r >> (LOG_E - 1), ~low & low_mask, low)
    return ((t >> LB) << (LB + LOG_E)) | (r << LB) | low


def _tile_schedule(log_t, LV, merge=False):
    """The phases of sort_small (log_t == 8: a warp's 256 slots, whatever
    the row's length) and sort_tiles (log_t >= 9) as
    (layout, stages): layout ("home",) or ("col", LB, mirror); a stage is
    (rmask, lmask, top, pairs of the network it must realise)."""
    def home_strides(B):
        return [(stride_rmask(b, LV), stride_lmask(b, LV), b, ("stride", b))
                for b in range(B, -1, -1)]

    def wide_strides(B):
        out = []
        while B >= LOG_WARP:
            LB = B - LOG_E + 1
            LO = max(LB, LOG_WARP)
            out.append((("col", LB, False),
                        [(1 << (b - LB), 0, b, ("stride", b))
                         for b in range(B, LO - 1, -1)]))
            B = LO - 1
        return out

    if merge:
        return wide_strides(log_t - 1) + [(("home",),
                                           home_strides(LOG_WARP - 1))]
    stages = []
    for L in range(1, LOG_WARP + 1):
        stages.append((flip_rmask(L, LV), flip_lmask(L, LV), L - 1,
                       ("flip", L)))
        stages += home_strides(L - 2)
    phases = [(("home",), stages)]
    for L in range(LOG_WARP + 1, log_t + 1):
        LB = L - LOG_E
        LO = max(LB, LOG_WARP)
        phases.append((("col", LB, True),
                       [(E - 1, 0, L - 1, ("flip", L))]
                       + [(1 << (b - LB), 0, b, ("stride", b))
                          for b in range(L - 2, LO - 1, -1)]))
        phases += wide_strides(LO - 1)
        phases.append((("home",), home_strides(LOG_WARP - 1)))
    return phases


def _stage_pairs(layout, stage, log_t, LV):
    """(lower slots, upper slots) of one stage, through the kernel's
    partner arithmetic, with the checks of ownership."""
    rmask, lmask, top, want = stage
    n_threads = 1 << log_t >> LOG_E
    t = np.arange(n_threads)[:, None]
    r = np.arange(E)[None, :]
    if layout[0] == "home":
        slot = home_slot(t, r, LV)
        partner = home_slot(t ^ lmask, r ^ rmask, LV)
        assert lmask < 32  # the partner is a lane of the same warp
        if LV <= top < LV + 5:
            lower = np.broadcast_to(((t & 31) & (1 << (top - LV))) == 0,
                                    slot.shape)
        else:
            top_reg = 1 << top if top < LV else 1 << (top - 5)
            lower = np.broadcast_to((r & top_reg) == 0, slot.shape)
        if lmask == 0:  # register pairs: the lower register is the smaller
            lower = np.broadcast_to((r ^ rmask) > r, slot.shape)
    else:
        _, LB, mirror = layout
        assert lmask == 0  # column stages never leave the thread
        slot = col_slot(t, r, LB, mirror)
        partner = col_slot(t, r ^ rmask, LB, mirror)
        lower = np.broadcast_to((r ^ rmask) > r, slot.shape)
    span = n_threads * E
    # every slot has exactly one owner, and its partner's partner is itself
    assert sorted(slot.ravel().tolist()) == list(range(span))
    back = np.empty(span, np.int64)
    back[slot.ravel()] = partner.ravel()
    assert np.array_equal(back[back], np.arange(span))
    lo, hi = slot[lower], partner[lower]
    assert lo.size == span // 2 and np.all(lo < hi)
    kind, x = want
    flipped = lo ^ ((1 << x) - 1) if kind == "flip" else lo ^ (1 << x)
    assert np.array_equal(hi, flipped)
    return lo, hi


def _apply(keys, vals, lo, hi, whole_pair=False):
    """One stage as a vector step: the pairs are disjoint; swap only when
    the upper key is strictly smaller.  `whole_pair`: an exchange between
    two lanes, which orders by (key, payload as unsigned) so that both
    lanes decide alike on equal keys."""
    a, b = keys[:, lo], keys[:, hi]
    va, vb = vals[:, lo], vals[:, hi]
    swap = b < a
    if whole_pair:
        unsigned = np.dtype(f"u{vals.dtype.itemsize}")
        swap |= (b == a) & (vb.view(unsigned) < va.view(unsigned))
    keys[:, lo], keys[:, hi] = np.where(swap, b, a), np.where(swap, a, b)
    vals[:, lo], vals[:, hi] = np.where(swap, vb, va), np.where(swap, va, vb)


def _network(keys, vals, LV=1):
    """The kernel's whole schedule on copies, in numpy: slots past C hold
    the key type's maximum beside the largest payload (and never move);
    rows longer than a tile run
    the tiles, then per merge size the global passes and the tiles' MERGE
    form.  -> (keys, vals, transposes of the first tile sort)."""
    G, C = keys.shape
    # a row of up to 256 slots is sorted as a warp's 256
    log_p = max(max(C - 1, 0).bit_length(), LOG_WARP)
    P = 1 << log_p
    pk = np.full((G, P), np.iinfo(keys.dtype).max, keys.dtype)
    pv = np.full((G, P), -1, vals.dtype)
    pk[:, :C], pv[:, :C] = keys, vals
    log_t = min(log_p, MAX_LOG_TILE)
    tile = 1 << log_t

    def run_tiles(merge):
        phases = _tile_schedule(log_t, LV, merge)
        for t0 in range(0, P, tile):
            for layout, stages in phases:
                for stage in stages:
                    lo, hi = _stage_pairs(layout, stage, log_t, LV)
                    _apply(pk, pv, lo + t0, hi + t0, whole_pair=stage[1] != 0)
        return sum(1 for a, b in zip(phases, phases[1:]) if a[0] != b[0])

    transposes = run_tiles(False)
    i = np.arange(P)
    for L in range(log_t + 1, log_p + 1):  # global passes, then MERGE tiles
        for b in [None] + list(range(L - 2, log_t - 1, -1)):
            p = i ^ ((1 << L) - 1) if b is None else i ^ (1 << b)
            m = (i < p) & (p < C)  # a pair reaching past C is skipped
            _apply(pk, pv, i[m], p[m])
        run_tiles(True)
    # padding never moved
    assert np.all(pk[:, C:] == np.iinfo(keys.dtype).max)
    assert np.all(pv[:, C:] == -1)
    return pk[:, :C], pv[:, :C], transposes


@pytest.mark.parametrize("case", CASES)
def test_kernel_network_sorts_any_length(case):
    for shape in SHAPES + [(1, 4097), (3, 300)]:
        keys = _keys(shape, np.int64, case, seed=shape[1])
        vals = np.arange(keys.size, dtype=np.int64).reshape(shape)
        gk, gv, _ = _network(keys, vals)
        _pairs_equal(gk, gv, np.sort(keys, axis=1),
                     np.take_along_axis(vals, np.argsort(keys, axis=1), 1))


@pytest.mark.parametrize("C", SEAMS)
@pytest.mark.parametrize("kd", [np.int32, np.int64])
def test_kernel_schedule_sorts_at_every_seam(kd, C):
    """The register / shuffle / transpose schedule, with each key width's
    own home layout (4 or 2 slots to a 16-byte chunk), sorts rows of every
    length at a seam of the kernel, pairs kept, padding unmoved."""
    LV = 2 if kd == np.int32 else 1
    for case in ("random", "mixed", "reversed"):
        keys = _keys((3, C), kd, case, seed=C)
        vals = np.arange(keys.size, dtype=np.int64).reshape(keys.shape)
        gk, gv, _ = _network(keys, vals, LV)
        _pairs_equal(gk, gv, np.sort(keys, axis=1),
                     np.take_along_axis(vals, np.argsort(keys, axis=1), 1))


@pytest.mark.parametrize("LV", [1, 2], ids=["int64", "int32"])
@pytest.mark.parametrize("log_t", range(LOG_WARP, MAX_LOG_TILE + 1))
def test_kernel_schedule_is_the_bitonic_network(log_t, LV):
    """Stage by stage the schedule is the direction-free bitonic network:
    flip(2^L) then strides 2^(L-2) .. 1 for L = 1 .. log_t, every slot
    owned once and paired once per stage (`_stage_pairs` asserts it), home
    stages inside a warp, column stages inside a thread; the MERGE form is
    the strides tile/2 .. 1."""
    def names(phases):
        return [st[3] for _, stages in phases for st in stages]

    phases = _tile_schedule(log_t, LV)
    for layout, stages in phases:
        for stage in stages:
            _stage_pairs(layout, stage, log_t, LV)
    want = []
    for L in range(1, log_t + 1):
        want += [("flip", L)] + [("stride", b) for b in range(L - 2, -1, -1)]
    assert names(phases) == want
    assert len(want) == log_t * (log_t + 1) // 2
    if log_t > LOG_WARP:
        merge = _tile_schedule(log_t, LV, merge=True)
        for layout, stages in merge:
            for stage in stages:
                _stage_pairs(layout, stage, log_t, LV)
        assert names(merge) == [("stride", b)
                                for b in range(log_t - 1, -1, -1)]


@pytest.mark.parametrize("log_t,transposes,wide_stages", [
    (8, 0, 0), (9, 2, 1), (10, 4, 3), (11, 6, 6), (12, 9, 10),
])
def test_kernel_schedule_barriers(log_t, transposes, wide_stages):
    """One barrier per transpose, not per stage: 4 transposes for the
    55 stages of a 1024-slot row, 6 for the 66 of a 2048-slot one; only the
    stages that cross warps (flip and strides >= 256 of merge sizes >= 512)
    run in column layouts."""
    phases = _tile_schedule(log_t, 1)
    assert sum(1 for a, b in zip(phases, phases[1:])
               if a[0] != b[0]) == transposes
    assert phases[0][0] == ("home",) and phases[-1][0] == ("home",)
    assert sum(len(stages) for layout, stages in phases
               if layout[0] == "col") == wide_stages


@pytest.mark.parametrize("vd", [None, torch.int32, torch.int64])
@pytest.mark.parametrize("kd", [torch.int32, torch.int64])
def test_sort_rows_cuda_on_cpu_runs_the_plain_version_in_place(kd, vd):
    keys = torch.from_numpy(_keys((6, 77), np.int64, "mixed")).to(kd)
    vals = None if vd is None else torch.arange(keys.numel(),
                                                dtype=vd).reshape(6, 77)
    wk, wv = rk.sort_rows_reference(keys, vals)
    before = rk.sort_rows_cuda.launches
    k2, v2 = keys.clone(), None if vals is None else vals.clone()
    gk, gv = rk.sort_rows_cuda(k2, v2)
    assert gk is k2 and gv is v2  # in place, as the kernel sorts
    assert rk.sort_rows_cuda.launches == before  # the plain version is no launch
    assert torch.equal(gk, wk)
    if vals is not None:
        assert torch.equal(gv, wv)
    # sort_rows: the wrapper, or with plain=True new tensors
    k3 = keys.clone()
    pk, _ = rk.sort_rows(k3, plain=True)
    assert torch.equal(pk, wk) and torch.equal(k3, keys)
    assert rk.sort_rows(k3)[0] is k3 and torch.equal(k3, wk)


@pytest.mark.parametrize("bad", [
    "1d", "float", "strided", "val_shape", "val_float", "val_strided",
])
def test_sort_rows_rejects_bad_input(bad):
    keys = torch.zeros((4, 10), dtype=torch.int64)
    vals = torch.zeros((4, 10), dtype=torch.int32)
    if bad == "1d":
        keys = keys.reshape(-1)
    elif bad == "float":
        keys = keys.float()
    elif bad == "strided":
        keys = keys[:, ::2]
    elif bad == "val_shape":
        vals = vals[:, :5]
    elif bad == "val_float":
        vals = vals.float()
    elif bad == "val_strided":
        vals = torch.zeros((4, 20), dtype=torch.int32)[:, ::2]
    for plain in (False, True):
        with pytest.raises((ValueError, TypeError)):
            rk.sort_rows(keys, vals, plain=plain)


@pytest.mark.cuda
@pytest.mark.parametrize("vd", [None, torch.int32, torch.int64])
@pytest.mark.parametrize("kd", [torch.int32, torch.int64])
def test_sort_rows_kernel_vs_plain_on_card(kd, vd):
    """The kernel against the plain version, exact, on every case and on
    a row long enough for the global passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    for shape in SHAPES + [(1, 1 << 18)]:
        for case in CASES:
            nd = np.int32 if kd == torch.int32 else np.int64
            keys = torch.from_numpy(_keys(shape, nd, case)).cuda()
            vals = None if vd is None else torch.randint(
                0, 1 << 30, shape, dtype=vd, device="cuda")
            wk, wv = rk.sort_rows_reference(keys, vals)
            before = rk.sort_rows_cuda.launches
            gk, gv = rk.sort_rows_cuda(keys.clone(),
                                       None if vals is None else vals.clone())
            torch.cuda.synchronize()
            assert rk.sort_rows_cuda.launches == before + 1
            assert torch.equal(gk, wk)
            if vals is not None:
                assert torch.equal(_vals_by_pair(gk, gv), _vals_by_pair(wk, wv))


def _vals_by_pair(keys, vals):
    """vals of each row ordered by (key, val): two stable sorts.  Equal
    results mean equal (key, val) multisets per row."""
    o = torch.sort(vals, dim=1, stable=True).indices
    o = o.gather(1, torch.sort(keys.gather(1, o), dim=1, stable=True).indices)
    return vals.gather(1, o)
