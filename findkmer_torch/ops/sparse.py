"""The sparse (sorted-run) count store of the port: compaction chain and
global finalize.

Counterpart of `findkmer_tpu/ops/sparse.py`.  For k above the dense
limit the store is log-structured: raw window codes append unsorted, and
a compaction sorts each row of the (G, C) store and run-length encodes it
(`compact_raw_2d` for raw codes with an implicit count of 1,
`compact_counted_2d` when the store's counts re-enter with new raw
codes).  Duplicates keep their code with count 0 ("holes"), so a row
stays sorted and can re-enter the next sort unchanged; `squeeze_2d` pushes
the holes to the row ends.  `global_compact` is the finalize: one flat
sort of the live entries and one entry per run, with its total: the
distinct sorted spectrum.  `merge_host_runs` and `store_to_host_2d` are
the host-side merges: of sorted runs (the disk spill's blocks, several
hosts' partial spectra) and of a pulled row store (the heap-merge
finalize).

Codes are one signed integer (`window.code_dtype`) whose max value
(`window.sentinel`) marks empty slots: the JAX (hi, lo) pair, its u16 hi
plane and its hole test on the hi word have no counterpart.  Every row
sort goes through `ops/cuda/rowsort_kernel.sort_rows` (the K3 kernel, or
its plain version), every run-length encoding through
`ops/cuda/rle_kernel.rle_rows` (the C2 kernel, or its plain version: the
torch scans that stand for the JAX package's); the flat finalize sort is
`torch.sort`, as it was XLA's flat sort in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from findkmer_torch.ops.cuda.rle_kernel import rle_rows
from findkmer_torch.ops.cuda.rowsort_kernel import sort_rows
from findkmer_torch.ops.window import sentinel


def ladder(n: int, floor: int = 1 << 20) -> int:
    """Smallest padded size >= n from the {1, 1.5} x 2^i ladder.

    Bounds padding waste (<= 50%, usually <= 33%) and the number of
    distinct store shapes a run produces."""
    c = floor
    while True:
        if n <= c:
            return c
        if n <= c + c // 2:
            return c + c // 2
        c *= 2


def rle_pos_2d(codes: torch.Tensor,
               count_dtype: torch.dtype = torch.int32,
               plain: bool = False) -> torch.Tensor:
    """Run lengths of sorted rows with an implicit count of 1 per entry:
    (G, C) of count_dtype, the run's length at its last position, 0
    elsewhere and at sentinels.  The C2 kernel on the card, its plain
    version on the CPU or with plain (`ops/cuda/rle_kernel.rle_rows`)."""
    return rle_rows(codes, None, count_dtype, plain)


def rle_val_2d(codes: torch.Tensor, cnt: torch.Tensor,
               plain: bool = False) -> torch.Tensor:
    """Run totals of sorted rows carrying explicit counts: the sum of each
    run's counts at its last position, 0 elsewhere and at sentinels, in
    cnt's dtype.  A total is exact whenever it fits the count dtype,
    whatever the row's running sum does (sums modulo 2^64: the JAX
    package's `seg_totals` contract).  The C2 kernel on the card writes
    the totals over cnt; its plain version (on the CPU, or with plain)
    returns a new tensor.  Use the returned tensor."""
    return rle_rows(codes, cnt, plain=plain)


def compact_raw_2d(codes: torch.Tensor, count_dtype: torch.dtype,
                   plain: bool = False):
    """Raw sentinel-masked (G, C) codes -> (sorted codes, run-total
    counts, per-row distinct).  The row sort may run in place on
    `codes`."""
    codes, _ = sort_rows(codes, plain=plain)
    cnt = rle_pos_2d(codes, count_dtype, plain)
    return codes, cnt, torch.count_nonzero(cnt, dim=1)


def compact_counted_2d(codes: torch.Tensor, cnt: torch.Tensor,
                       plain: bool = False):
    """Count-carrying compaction: one row sort of (code, count) pairs +
    run totals.  The sort may run in place on `codes` and `cnt`, and the
    totals over `cnt` (on the card): callers use the returned tensors,
    never the inputs."""
    codes, cnt = sort_rows(codes, cnt, plain=plain)
    cnt = rle_val_2d(codes, cnt, plain)
    return codes, cnt, torch.count_nonzero(cnt, dim=1)


def compact_raw(codes: torch.Tensor, count_dtype: torch.dtype = torch.int32):
    """One flat plane of raw sentinel-masked codes -> (sorted codes,
    run-total counts, distinct): the reference's 1-D `compact_raw` on the
    port's one code plane (a row of `compact_raw_2d`).  Duplicates keep
    their code with count 0; distinct is a 0-d tensor.  The sort may run
    in place on `codes`."""
    codes, cnt, d = compact_raw_2d(codes.reshape(1, -1), count_dtype)
    return codes.reshape(-1), cnt.reshape(-1), d[0]


def compact_counted(codes: torch.Tensor, cnt: torch.Tensor):
    """The count-carrying compaction of one flat plane of (code, count)
    pairs -> (sorted codes, run totals at each run's end, distinct): the
    reference's 1-D `compact_counted` (a row of `compact_counted_2d`).
    The sort may run in place on `codes` and `cnt`, and the totals over
    `cnt` (on the card): use the returned tensors, never the inputs."""
    codes, cnt, d = compact_counted_2d(codes.reshape(1, -1),
                                       cnt.reshape(1, -1))
    return codes.reshape(-1), cnt.reshape(-1), d[0]


def squeeze_2d(codes: torch.Tensor, cnt: torch.Tensor, plain: bool = False):
    """Push each row's zero-count holes to its end (holes re-keyed to the
    sentinel), live entries sorted at the front.  May sort `cnt` in
    place: the input store is consumed."""
    keys = torch.where(cnt > 0, codes, sentinel(codes.dtype))
    return sort_rows(keys, cnt, plain=plain)


def global_compact(
    codes: torch.Tensor, cnt: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A store of any shape -> its spectrum on the device: (codes, counts)
    flat, sorted ascending, distinct, counts > 0.

    The live entries (count > 0; holes and padding dropped) go through
    one flat `torch.sort`; each run of equal codes then keeps one entry,
    its last, with the run's total (an int64 cumsum differenced between
    run ends: exact modulo 2^64, so whenever the total fits the count
    dtype).  Rows may share codes; the flat sort folds them.
    Synchronises with the host (the live and distinct counts size the
    results)."""
    cnt = cnt.reshape(-1)
    live = cnt > 0
    keys, order = torch.sort(codes.reshape(-1)[live])
    vals = cnt[live][order]
    del live, order
    if keys.numel() == 0:
        return keys, vals
    is_end = torch.ones_like(keys, dtype=torch.bool)
    torch.ne(keys[1:], keys[:-1], out=is_end[:-1])
    ends = torch.nonzero(is_end).squeeze(1)
    tot = torch.cumsum(vals, 0, dtype=torch.int64)[ends]
    tot = torch.diff(tot, prepend=tot.new_zeros(1))
    return keys[ends], tot.to(cnt.dtype)


def merge_host_runs(runs):
    """G-way merge of sorted distinct (codes u64, counts) runs on the
    host, summing the counts of codes that several runs hold -> (codes
    uint64 sorted distinct, counts int64).

    One C heap-merge pass (`io/native.merge_runs`) where the C library is
    built, over 256 runs at a time and then over the partial results; a
    numpy sort otherwise.  A single run passes through unchanged."""
    runs = [(c, n) for c, n in runs if c.size]
    if not runs:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    if len(runs) == 1:
        c, n = runs[0]
        return (c.astype(np.uint64, copy=False),
                n.astype(np.int64, copy=False))
    from findkmer_torch.io import native

    if native.available():
        step = native.MERGE_MAX_RUNS
        if len(runs) <= step:
            return native.merge_runs(runs)
        return merge_host_runs([native.merge_runs(runs[i : i + step])
                                for i in range(0, len(runs), step)])
    codes = np.concatenate([c for c, _ in runs]).astype(np.uint64,
                                                        copy=False)
    cnts = np.concatenate([n for _, n in runs]).astype(np.int64, copy=False)
    order = np.argsort(codes, kind="stable")
    codes, cnts = codes[order], cnts[order]
    starts = np.flatnonzero(np.concatenate([[True], codes[1:] != codes[:-1]]))
    return codes[starts], np.add.reduceat(cnts, starts)


def store_to_host_2d(codes: np.ndarray, cnt: np.ndarray):
    """A pulled row store (G, C) -> (codes uint64 sorted distinct, counts
    int64).

    Each row is sorted and run-length encoded, but rows may share codes:
    strip each row's holes and padding BY COUNT (a slot's code says
    nothing: a hole keeps its code) and heap-merge the G runs."""
    codes = np.asarray(codes)
    cnt = np.asarray(cnt)
    live = cnt > 0
    # one strip of the whole store: its live entries in row-major order
    # are the rows' runs end to end, cut at the rows' live counts (and
    # only live entries pay the widening copy)
    ends = np.cumsum(live.sum(axis=1))
    flat_codes = codes[live].astype(np.uint64)
    flat_cnt = cnt[live]
    runs = [(flat_codes[a:b], flat_cnt[a:b])
            for a, b in zip(ends - np.diff(ends, prepend=0), ends) if b > a]
    return merge_host_runs(runs)
