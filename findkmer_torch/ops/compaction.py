"""Row-store compaction of the port's sparse engine.

Counterpart of `findkmer_tpu/ops/compaction.py`: the raw code buffer
folds into a (G, cols) store of independently sorted, run-length encoded
rows; `squeeze_slice` cuts the holes off the row ends; `dedup_rows` folds
codes that landed in several rows when the capacity check needs the
exact distinct count.  Each step is one row sort (`sort_rows`: the K3
kernel, or its plain version when `plain`) plus scans (`ops/sparse.py`).

A store is a pair (codes, counts) of (G, cols) tensors.  PyTorch has no
buffer donation; instead the row sort runs in place where the kernel
runs, so a step may consume the buffers it is given (noted per function)
and the caller replaces them, as the JAX callers do with donated ones.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from findkmer_torch.ops import sparse as sparse_ops
from findkmer_torch.ops.window import sentinel


def row_geometry(cap0: int, g0: int = 1, g_cap: int = 262144) -> int:
    """Row count of a sorted store over raw capacity cap0.

    The JAX package's rule, kept so both stores have the same geometry:
    more rows are shorter rows (fewer sort stages); the result is a power
    of two from the floor g0, at most cap0/256 and g_cap, so it divides
    cap0 and every larger ladder capacity."""
    g = g0
    while g < g_cap and g * 256 <= cap0:
        g *= 2
    return g


def _pad_cols(a: torch.Tensor, pad: int, value: int) -> torch.Tensor:
    if not pad:
        return a
    fill = torch.full((a.shape[0], pad), value, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, fill], dim=1)


def compact_raw_rows(buf: torch.Tensor, G: int, L: int,
                     count_dtype: torch.dtype, plain: bool = False):
    """First compaction (no store): raw sentinel-masked codes (any shape
    of size G * cols) -> ((codes, counts) store of (G, L), per-row
    distinct (G,)).  Rows are the row-major reshape, padded with the
    sentinel to L columns.  Consumes `buf` (sorted in place)."""
    codes = _pad_cols(buf.reshape(G, -1), L - buf.numel() // G,
                      sentinel(buf.dtype))
    codes, cnt, d = sparse_ops.compact_raw_2d(codes, count_dtype, plain)
    return (codes, cnt), d


def compact_counted_rows(store, buf: torch.Tensor, G: int, L: int,
                         plain: bool = False):
    """Store-carrying compaction: each store row keeps its counts, raw
    codes enter row-wise with count 1, one row sort + run totals.  L is
    the padded column target (>= store cols + raw cols); the count
    dtype follows the store."""
    codes, cnt = store
    raw = buf.reshape(G, -1)
    pad = L - codes.shape[1] - raw.shape[1]
    codes = _pad_cols(torch.cat([codes, raw], dim=1), pad,
                      sentinel(codes.dtype))
    ones = torch.ones(raw.shape, dtype=cnt.dtype, device=cnt.device)
    cnt = _pad_cols(torch.cat([cnt, ones], dim=1), pad, 0)
    codes, cnt, d = sparse_ops.compact_counted_2d(codes, cnt, plain)
    return (codes, cnt), d


def squeeze_slice(store, Ld: int, plain: bool = False):
    """Sort each row's zero-count holes to its end and keep Ld columns.
    Consumes `store`."""
    codes, cnt = sparse_ops.squeeze_2d(*store, plain=plain)
    return codes[:, :Ld].contiguous(), cnt[:, :Ld].contiguous()


def dedup_rows(
    store, D: int, sub: int, col_floor: int, plain: bool = False
) -> Tuple[tuple, int, np.ndarray]:
    """Cross-row dedup within D groups -> the EXACT distinct count.

    A code that landed in several rows has an entry in each, so the sum
    of per-row distinct counts can exceed the true distinct count on
    repeat-heavy input.  Each group's rows concatenate (row-major
    reshape), one sort + run totals folds the duplicates, and the
    squeezed live prefix re-splits into `sub` contiguous sorted rows per
    group (contiguous chunks of a sorted sequence are sorted disjoint
    rows, so a finalize without recompaction stays exact).  The long
    group rows take the kernel's global passes.  Consumes `store`.

    Returns (store with D * sub rows of Lc cols, Lc, per-row distinct
    (D * sub,) int64 on the host)."""
    codes, cnt = (a.reshape(D, -1) for a in store)
    codes, cnt, d = sparse_ops.compact_counted_2d(codes, cnt, plain)
    dmax = int(d.max())
    Lc = sparse_ops.ladder(max(-(-dmax // sub), 1), floor=col_floor)
    codes, cnt = squeeze_slice((codes, cnt), sub * Lc, plain)
    store2 = (codes.reshape(D * sub, Lc), cnt.reshape(D * sub, Lc))
    drows = torch.count_nonzero(store2[1], dim=1).cpu().numpy()
    return store2, Lc, drows.astype(np.int64)
