"""K3, the row sort of the sparse store: its plain version, its wrapper
on the CPU, and the kernel's schedule.

The kernel itself runs only on a CUDA card (the `cuda` tests at the end;
`chip_smoke.py` holds it against the plain version at the production
shapes).  Here its schedule is replayed in numpy with the index
arithmetic of `csrc/rowsort.cu`: the tile network phase by phase (the home
layout's register and shuffle stages, the column layouts between
shared-memory transposes, the slots past C that act as +infinity), and
for rows longer than a tile the merge-path passes block by block and
thread by thread (the splits, the shared-memory slices, the serial
merges, the scratch ping-pong and the copy home); keys are integers, so
every check is exact.
"""

import functools
import re
from pathlib import Path

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


def _tile_schedule(log_t, LV):
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


@functools.lru_cache(maxsize=None)
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
    """The kernel's whole schedule on copies, in numpy.  Rows of up to a
    tile run the network at next_pow2(C) (at least a warp's 256 slots),
    the slots past C holding the key type's maximum beside the largest
    payload, which never move.  Longer rows take the spans' sort inside
    shared memory (`_sort_spans`), then the merge passes
    (`_merge_passes`).  -> (keys, vals, transposes of the network)."""
    G, C = keys.shape
    if C > TILE:
        slot = keys.itemsize + vals.itemsize
        rk_, rv_ = keys.copy(), vals.copy()
        _sort_spans(rk_, rv_, slot)
        rk_, rv_ = _merge_passes(rk_, rv_, slot)
        return rk_, rv_, 0
    log_t = max(max(C - 1, 0).bit_length(), LOG_WARP)
    P = 1 << log_t
    pk = np.full((G, P), np.iinfo(keys.dtype).max, keys.dtype)
    pv = np.full((G, P), -1, vals.dtype)
    pk[:, :C], pv[:, :C] = keys, vals
    phases = _tile_schedule(log_t, LV)
    for layout, stages in phases:
        for stage in stages:
            lo, hi = _stage_pairs(layout, stage, log_t, LV)
            _apply(pk, pv, lo, hi, whole_pair=stage[1] != 0)
    # padding never moved
    assert np.all(pk[:, C:] == np.iinfo(keys.dtype).max)
    assert np.all(pv[:, C:] == -1)
    transposes = sum(1 for a, b in zip(phases, phases[1:]) if a[0] != b[0])
    return pk[:, :C], pv[:, :C], transposes


# ---- rows longer than a tile: the merge sort, replayed ----------------------
#
# The constants are read out of the source, so the replay cannot drift
# from the kernel.  sort_spans: a block of SPAN_THREADS loads a span of
# span_slots slots of a row into shared memory, thread t sorts slots t*VT
# .. t*VT + VT - 1 in registers (a direction-free bitonic network), then
# the runs merge level by level, thread t merging outputs t*VT .. of its
# pair from its own diagonal.  A merge pass merges each pair of
# neighbouring runs of w slots: span b owns output slots [o0, o0 +
# MERGE_SPAN) of its row, its splits are `merge_path` at its two diagonals
# (one a span from the partition launch), its a and b slices go to shared
# memory, and each of MERGE_THREADS threads merges MERGE_VT outputs there.

_SRC = (Path(__file__).resolve().parents[1] / "findkmer_torch" / "csrc"
        / "rowsort.cu").read_text()


def _constexpr(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


MERGE_THREADS = _constexpr("kMergeThreads")
MERGE_VT = _constexpr("kMergeVT")
MERGE_SPAN = MERGE_THREADS * MERGE_VT
SPAN_THREADS = _constexpr("kSpanThreads")
TILE = 1 << MAX_LOG_TILE
assert _constexpr("kMaxLogTile") == MAX_LOG_TILE
# kSpanSlots: the slots of a span sorted inside shared memory, by the
# bytes of a key and its payload together
_SPAN_CUT, _SPAN_WIDE, _SPAN_NARROW = map(int, re.search(
    r"kSpanSlots = kSlotBytes<K, V> > (\d+) \? (\d+) : (\d+);",
    _SRC).groups())


def _span_slots(slot):
    return _SPAN_WIDE if slot > _SPAN_CUT else _SPAN_NARROW


def _pass_count(C, slot):
    """`merge_passes` of the kernel: one per run width _span_slots,
    twice that, .. below C."""
    w, n = _span_slots(slot), 0
    while w < C:
        w, n = 2 * w, n + 1
    return n


def _merge_path(src, a_off, na, b_off, nb, d):
    """`merge_path` of the kernel, vectorized: for each search, how many
    of the first d outputs of merging src[a_off:a_off+na] and
    src[b_off:b_off+nb] come from a, a first on ties."""
    lo = np.maximum(d - nb, 0)
    hi = np.minimum(d, na)
    while True:
        act = lo < hi
        if not act.any():
            return lo
        mid = (lo + hi) >> 1
        ia = np.where(act, a_off + mid, 0)
        ib = np.where(act, b_off + d - 1 - mid, 0)
        take = src[ia] <= src[ib]
        lo = np.where(act & take, mid + 1, lo)
        hi = np.where(act & ~take, mid, hi)


def _skew(j, vt):
    return j + j // vt


def _merge_serial(sk, sv, a0, na, b0, nb, d, vt, n_out, dst, ok, ov, out):
    """`merge_serial` for many threads at once (flat shared copies sk,
    sv; a0 .. d one entry a thread): each thread's vt outputs into ok, ov
    at dst + r where r < n_out, counted in `out`."""
    i = _merge_path(sk, a0, na, b0, nb, d)
    j = d - i
    for r in range(vt):
        ia = np.where(i < na, a0 + i, 0)
        ib = np.where(j < nb, b0 + j, 0)
        take_a = (i < na) & ((j >= nb) | (sk[ia] <= sk[ib]))
        frm = np.where(take_a, ia, ib)
        real = r < n_out
        ok[dst[real] + r] = sk[frm[real]]
        ov[dst[real] + r] = sv[frm[real]]
        np.add.at(out, dst[real] + r, 1)
        i = i + take_a
        j = j + ~take_a


def _register_network(vt):
    """`sort_registers`: the direction-free bitonic network on vt
    registers, as (lower, upper) register pairs a stage."""
    r = np.arange(vt)
    stages = []
    s = 2
    while s <= vt:
        flip = r ^ (s - 1)
        stages.append((r[flip > r], flip[flip > r]))
        j = s // 4
        while j:
            stages.append((r[(r & j) == 0], r[(r & j) == 0] | j))
            j //= 2
        s *= 2
    return stages


def _sort_spans(keys, vals, slot):
    """sort_spans in place on (G, C) rows: per span of span_slots, each
    busy thread's VT slots through the register network (the slots past
    the span's end loaded as the key type's maximum beside payload -1,
    which never move), then each level through shared memory; every slot
    written exactly once a level."""
    G, C = keys.shape
    S = _span_slots(slot)
    vt = S // SPAN_THREADS
    mx = np.iinfo(keys.dtype).max
    for row in range(G):
        for o0 in range(0, C, S):
            n = min(S, C - o0)
            sk, sv = keys[row, o0:o0 + n], vals[row, o0:o0 + n]  # views
            busy = -(-n // vt)
            rk_ = np.full(busy * vt, mx, keys.dtype)
            rv_ = np.full(busy * vt, -1, vals.dtype)
            rk_[:n], rv_[:n] = sk, sv
            tk, tv = rk_.reshape(busy, vt), rv_.reshape(busy, vt)
            for lo, hi in _register_network(vt):
                _apply(tk, tv, lo, hi)
            assert np.all(rk_[n:] == mx) and np.all(rv_[n:] == -1)
            sk[:], sv[:] = rk_[:n], rv_[:n]
            q0 = np.arange(busy) * vt
            w = vt
            while w < n:
                p0 = q0 & ~(2 * w - 1)
                na = np.minimum(w, n - p0)
                nb = np.minimum(2 * w, n - p0) - na
                ok, ov = np.empty_like(sk), np.empty_like(sv)
                out = np.zeros(n, np.int64)
                _merge_serial(sk, sv, p0, na, p0 + na, nb, q0 - p0, vt,
                              np.minimum(vt, n - q0), q0, ok, ov, out)
                assert np.all(out == 1)
                sk[:], sv[:] = ok, ov
                w *= 2


def _merge_pass(ik, iv, ok, ov, G, C, w):
    """One merge pass from (ik, iv) into (ok, ov), flat (G * C), with
    the kernel's index arithmetic; asserts that every output slot is
    written exactly once."""
    spans = -(-C // MERGE_SPAN)
    b = np.arange(G * spans)
    row = b // spans
    o0 = (b - row * spans) * MERGE_SPAN
    n = np.minimum(MERGE_SPAN, C - o0)
    p0 = o0 & ~(2 * w - 1)  # the pair: runs of na and nb slots
    left = C - p0
    na = np.minimum(left, w)
    nb = np.minimum(left, 2 * w) - na
    base = row * C + p0
    d0 = o0 - p0
    d1 = d0 + n
    # the partition launch: one split a span; a span's end is the next
    # span's start unless it ends its pair
    parts = _merge_path(ik, base, na, base + na, nb, d0)
    last = d1 == na + nb
    nxt = np.minimum(b + 1, b.size - 1)
    assert np.all(last | (row[nxt] == row) & (p0[nxt] == p0))
    i0 = parts
    i1 = np.where(last, na, parts[nxt])
    # which is where the diagonal of the span's end splits the pair
    assert np.array_equal(i1, _merge_path(ik, base, na, base + na, nb, d1))
    la = i1 - i0
    assert np.all((0 <= la) & (la <= n) & (0 <= i0) & (i1 <= na))
    # the span's shared slice: a's slots then b's, n in all
    j = np.arange(MERGE_SPAN)[None, :]
    src = np.where(j < la[:, None], base[:, None] + i0[:, None] + j,
                   base[:, None] + na[:, None] + (d0 - i0)[:, None]
                   + j - la[:, None])
    real = j < n[:, None]
    assert np.all(~real | (src >= base[:, None])
                  & (src < (base + na + nb)[:, None]))  # inside the pair
    sk = np.where(real, ik[np.where(real, src, 0)], 0).ravel()
    sv = np.where(real, iv[np.where(real, src, 0)], 0).ravel()
    # each thread: its diagonal in the slice, then MERGE_VT serial steps
    t = np.arange(MERGE_THREADS)[None, :]
    blk = np.arange(b.size)[:, None] * MERGE_SPAN
    q0 = t * MERGE_VT
    busy = q0 < n[:, None]
    la2 = np.broadcast_to(la[:, None], busy.shape)[busy]
    n2 = np.broadcast_to(n[:, None], busy.shape)[busy]
    out = np.zeros(G * C, np.int64)
    _merge_serial(sk, sv, np.broadcast_to(blk, busy.shape)[busy], la2,
                  np.broadcast_to(blk, busy.shape)[busy] + la2, n2 - la2,
                  np.broadcast_to(q0, busy.shape)[busy], MERGE_VT,
                  np.minimum(MERGE_VT, n2 - np.broadcast_to(q0, busy.shape)[busy]),
                  np.broadcast_to((row * C + o0)[:, None] + q0,
                                  busy.shape)[busy], ok, ov, out)
    assert np.all(out == 1)  # every output slot written exactly once


def _merge_passes(keys, vals, slot):
    """The passes of rows whose spans of span_slots are sorted: ping-pong
    between the rows and a scratch (whose contents start undefined), then
    the copy home after an odd pass count."""
    G, C = keys.shape
    bufs = [(keys.ravel().copy(), vals.ravel().copy()),
            (np.full(G * C, -77, keys.dtype), np.full(G * C, -77, vals.dtype))]
    w, m = _span_slots(slot), 0
    while w < C:
        (ik, iv), (ok, ov) = bufs[m % 2], bufs[(m + 1) % 2]
        _merge_pass(ik, iv, ok, ov, G, C, w)
        w, m = 2 * w, m + 1
    assert m == _pass_count(C, slot)
    home = bufs[0]
    if m % 2:
        home[0][:], home[1][:] = bufs[1]
    return home[0].reshape(G, C), home[1].reshape(G, C)


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
    stages inside a warp, column stages inside a thread."""
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


# row lengths past the tile: the sort inside shared memory alone (4097
# .. 12289, for 12-byte slots; 8193 and 12289 take a pass at 16 bytes),
# one merge pass at 16385 (the copy home), two at 32769, three at 2^16 + 3
LONG_SEAMS = [4097, 8191, 8192, 8193, 12289, 16385, 32769, (1 << 16) + 3]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("kd", [np.int32, np.int64])
@pytest.mark.parametrize("C", LONG_SEAMS)
def test_merge_path_schedule_sorts_long_rows(C, kd, G, case):
    """The spans' sort inside shared memory, then the merge passes, block
    by block and thread by thread (int64 payloads: 12-byte slots beside
    int32 keys, 16 beside int64): every output slot written once a level
    and a pass, the rows sorted, every (key, payload) pair kept under
    distinct payloads, so that a run of equal keys split between threads
    or blocks is neither lost nor doubled."""
    LV = 2 if kd == np.int32 else 1
    keys = _keys((G, C), kd, case, seed=C + G)
    vals = np.arange(keys.size, dtype=np.int64).reshape(keys.shape)
    gk, gv, _ = _network(keys, vals, LV)
    _pairs_equal(gk, gv, np.sort(keys, axis=1),
                 np.take_along_axis(vals, np.argsort(keys, axis=1), 1))


# (C, key bytes, payload bytes, merge passes)
PASSES = [
    (1, 8, 4, 0), (4096, 8, 4, 0), (4097, 8, 4, 0), (16384, 8, 4, 0),
    (16385, 8, 4, 1), (32769, 8, 4, 2), ((1 << 16) + 3, 8, 4, 3),
    (1 << 22, 8, 4, 8), (1 << 26, 8, 4, 12), (1 << 26, 8, 0, 12),
    (8193, 8, 8, 1), (16385, 8, 8, 2),
]


@pytest.mark.parametrize("C,kb,vb,passes", PASSES)
def test_merge_passes(C, kb, vb, passes):
    """One pass per run width, the span, twice that, .. below C (the
    whole 2^26-slot dedup row takes 12): after an odd count the rows come
    home by one copy of the scratch."""
    assert _pass_count(C, kb + vb) == passes


def test_merge_path_ties_take_a_first():
    """The split of a run of equal keys: a first, so a diagonal inside
    the run takes every a slot before any b slot."""
    src = np.array([1, 5, 5, 5, 5, 5, 5, 9], np.int64)  # a = [1, 5, 5, 5]
    a_off, na, b_off, nb = 0, 4, 4, 4                    # b = [5, 5, 5, 9]
    got = [int(_merge_path(src, np.array([a_off]), np.array([na]),
                           np.array([b_off]), np.array([nb]),
                           np.array([d]))[0]) for d in range(9)]
    assert got == [0, 1, 2, 3, 4, 4, 4, 4, 4]


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("vt,threads", [
    (MERGE_VT, MERGE_THREADS), (16, SPAN_THREADS), (32, SPAN_THREADS),
])
def test_merge_store_skew_hits_distinct_banks(vt, threads, word):
    """The registers' trip back to shared memory: thread t writes slot t *
    vt + r at `skew`, one store a register; the 32 lanes of a warp (two
    halves of 16 for 8-byte words, as the card serves them) touch
    distinct banks of 4 bytes, in a merge pass (vt = MERGE_VT) and in
    sort_spans (vt = span_slots / SPAN_THREADS: 16 or 32)."""
    lanes = 32 if word == 4 else 16
    for r in range(vt):
        for first in range(0, threads, lanes):
            t = np.arange(first, first + lanes)
            addr = _skew(t * vt + r, vt) * word
            banks = {(a // 4 + x) % 32 for a in addr for x in range(word // 4)}
            assert len(banks) == lanes * word // 4


@pytest.mark.parametrize("vt", [2, 4, 8, 16, 32])
def test_register_network_sorts_and_keeps_padding(vt):
    """`sort_registers` is a sorting network on vt registers (0-1
    principle: every 0/1 input comes out sorted), and a padded tail of
    the key type's maximum stays where it was loaded."""
    stages = _register_network(vt)
    bits = (np.arange(1 << min(vt, 16))[:, None] >> np.arange(vt)) & 1
    if vt > 16:  # 2^32 inputs are too many: a seeded sample
        bits = np.random.default_rng(vt).integers(0, 2, (1 << 14, vt))
    k = bits.astype(np.int64)
    v = np.zeros_like(k)
    for lo, hi in stages:
        _apply(k, v, lo, hi)
    assert np.all(np.diff(k, axis=1) >= 0)
    mx = np.iinfo(np.int64).max
    for n in range(1, vt):
        k = np.full((1, vt), mx, np.int64)
        k[0, :n] = np.arange(n, 0, -1) % 3
        v = np.arange(vt, dtype=np.int64)[None, :]
        for lo, hi in stages:
            _apply(k, v, lo, hi)
        assert np.array_equal(v[0, n:], np.arange(n, vt))


@pytest.mark.parametrize("slot", [4, 8, 12, 16])
def test_span_geometry_fits_the_blocks(slot):
    """A span of sort_spans is longer than a tile and a whole number of
    its threads' slots and of a merge pass's block spans, so a thread's
    slots never straddle two runs, nor a block's span two pairs of runs,
    and its bytes fit the 227 KB of shared memory a block may have."""
    span = _span_slots(slot)
    vt = span // SPAN_THREADS
    assert span > TILE
    assert span % SPAN_THREADS == 0 and span % MERGE_SPAN == 0
    # smem_slots: the span, one skew slot every vt, two threads' padding
    assert (span + span // vt + 2 * vt) * slot <= 227 * 1024


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
    """The kernel against the plain version, exact, on every case: the
    tile path's shapes, a row of 2^18 (four merge passes), the seams of
    the long rows for one and three rows, and one row of 2^22 on the
    duplicates case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    nd = np.int32 if kd == torch.int32 else np.int64
    shapes = (SHAPES + [(1, 1 << 18)]
              + [(G, C) for C in LONG_SEAMS for G in (1, 3)] + [(1, 1 << 22)])
    for shape in shapes:
        for case in CASES + ["duplicates"]:
            if shape[1] == 1 << 22 and case != "duplicates":
                continue
            if case == "duplicates":  # few keys, a payload a slot
                keys = torch.randint(0, 50, shape, dtype=kd, device="cuda")
            else:
                keys = torch.from_numpy(_keys(shape, nd, case)).cuda()
            if vd is None:
                vals = None
            elif case == "duplicates":
                vals = torch.arange(keys.numel(), dtype=vd,
                                    device="cuda").reshape(shape)
            else:
                vals = torch.randint(0, 1 << 30, shape, dtype=vd,
                                     device="cuda")
            wk, wv = rk.sort_rows_reference(keys, vals)
            before = rk.sort_rows_cuda.launches
            long0 = rk.sort_rows_cuda.long_launches
            gk, gv = rk.sort_rows_cuda(
                keys.clone(), None if vals is None else vals.clone())
            torch.cuda.synchronize()
            assert rk.sort_rows_cuda.launches == before + 1
            assert (rk.sort_rows_cuda.long_launches
                    == long0 + (shape[1] > TILE))
            assert torch.equal(gk, wk)
            if vals is not None:
                assert torch.equal(_vals_by_pair(gk, gv),
                                   _vals_by_pair(wk, wv))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [12289, 16385, 32769])
def test_sort_rows_kernel_scratch_on_card(C):
    """The merge passes ping-pong through a scratch that the wrapper
    allocates: after no pass (12289), an odd (16385: one) and an even
    (32769: two) pass count the caller's own tensors hold the sorted
    rows, and no other tensor is written (guards allocated around them
    keep their bytes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    shape = (3, C)
    guard = [torch.full(shape, -3, dtype=torch.int64, device="cuda")
             for _ in range(2)]
    keys = torch.from_numpy(_keys(shape, np.int64, "mixed")).cuda()
    vals = torch.arange(keys.numel(), dtype=torch.int32,
                        device="cuda").reshape(shape)
    guard += [torch.full(shape, -3, dtype=torch.int64, device="cuda")
              for _ in range(2)]
    wk, wv = rk.sort_rows_reference(keys, vals)
    ptrs = keys.data_ptr(), vals.data_ptr()
    gk, gv = rk.sort_rows_cuda(keys, vals)
    torch.cuda.synchronize()
    assert gk is keys and gv is vals
    assert (keys.data_ptr(), vals.data_ptr()) == ptrs
    assert torch.equal(keys, wk)
    assert torch.equal(_vals_by_pair(keys, vals), _vals_by_pair(wk, wv))
    assert all(bool((g == -3).all()) for g in guard)
    assert rk.sort_plan(3, C, 8, 4).passes == {12289: 0, 16385: 1,
                                               32769: 2}[C]


@pytest.mark.cuda
@pytest.mark.parametrize("C,kb,vb,passes", PASSES)
def test_sort_plan_on_card(C, kb, vb, passes):
    """The library's plan (`fk_sort_rows_scratch`) is the replay's: the
    same merge passes, the splits of a block span each a pass takes, the
    merge sort on rows longer than a tile, and a refusal of sizes the
    kernel has no form for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    G = 3
    assert rk.sort_plan(G, C, kb, vb) == (
        C > TILE, passes, G * -(-C // MERGE_SPAN) if passes else 0)
    with pytest.raises(ValueError):
        rk.sort_plan(G, C, kb, 2)


def _vals_by_pair(keys, vals):
    """vals of each row ordered by (key, val): two stable sorts.  Equal
    results mean equal (key, val) multisets per row."""
    o = torch.sort(vals, dim=1, stable=True).indices
    o = o.gather(1, torch.sort(keys.gather(1, o), dim=1, stable=True).indices)
    return vals.gather(1, o)
