"""Raw-buffer growth and the row store's capacity, dedup and table logic.

Counterpart of `findkmer_tpu/models/rowstore.py` for the single-device
engine.  The geometry contract is the JAX package's: a store is
(D * R, L), D device groups of R rows (one device: D = 1, R = G), and
`distinct` is the per-row distinct vector of the last compaction.  The
capacity metric is the largest per-group sum, because sparse_capacity
bounds the DISTINCT k-mers resident on one device.

`adopt_spill_runs` waits for the spill slice (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from findkmer_torch import table as table_mod
from findkmer_torch.ops import compaction
from findkmer_torch.ops import sparse as sparse_ops
from findkmer_torch.ops.window import code_dtype, sentinel


def fresh_raw(cap: int, dtype: torch.dtype, device) -> torch.Tensor:
    """An empty raw code buffer: (cap,) sentinels."""
    return torch.full((cap,), sentinel(dtype), dtype=dtype, device=device)


def grow_raw(raw: torch.Tensor, new_cap: int) -> torch.Tensor:
    """Extend a raw buffer to new_cap slots, sentinel-filled (ladder
    growth)."""
    tail = fresh_raw(new_cap - raw.shape[0], raw.dtype, raw.device)
    return torch.cat([raw, tail])


def merge_host_entries(codes: np.ndarray, counts: np.ndarray):
    """Host entries with repeats -> (codes uint64 sorted distinct, counts
    int64 summed)."""
    codes = codes.astype(np.uint64, copy=False)
    counts = counts.astype(np.int64, copy=False)
    if codes.size == 0:
        return codes, counts
    order = np.argsort(codes, kind="stable")
    codes, counts = codes[order], counts[order]
    starts = np.flatnonzero(np.concatenate([[True], codes[1:] != codes[:-1]]))
    return codes[starts], np.add.reduceat(counts, starts)


def table_entries(table, k: int):
    """Any sparse table's live entries on the host: (codes uint64,
    counts), repeats possible.  Takes the port's SparseTable (codes,
    counts) or one with host planes (hi, lo, cnt), such as the JAX
    counter's `table_state`: its codes are (hi << 32) | lo; sentinels and
    holes carry count 0 and are stripped by count, whatever their code
    planes hold."""
    if table.k != k:
        raise ValueError(f"table is for k={table.k}, counter for k={k}")
    if hasattr(table, "codes"):
        codes = torch.as_tensor(table.codes).cpu().numpy()
        cnt = torch.as_tensor(table.counts).cpu().numpy()
        live = cnt > 0
        return codes[live].astype(np.uint64), cnt[live]
    hi = np.asarray(table.hi)
    lo = np.asarray(table.lo)
    cnt = np.asarray(table.cnt)
    live = cnt > 0
    codes = (hi[live].astype(np.uint64) << np.uint64(32)) | lo[live].astype(
        np.uint64)
    return codes, cnt[live]


class RowStoreMixin:
    """Capacity / dedup / table logic of the sparse engine.

    Subclass contract: `self.cfg`, `self.device`, `self._plain_sort` and
    `_dedup_geometry() -> (D, R, col_floor)`.  State objects are
    dataclasses with fields (raw, fill, store, store_len, distinct)."""

    def _dedup_geometry(self):
        raise NotImplementedError

    def _distinct_total(self, d) -> int:
        """Worst per-group distinct upper bound: the rows of one group sum
        (a code in several rows counts once per row), groups take the
        max."""
        D, _, _ = self._dedup_geometry()
        return int(np.asarray(d).reshape(D, -1).sum(axis=1).max())

    def _dedup_state(self, st):
        """Cross-row dedup (compaction.dedup_rows): EXACT per-row distinct
        counts.  Runs only when the entry sum crosses sparse_capacity."""
        D, R, floor = self._dedup_geometry()
        store, Lc, drows = compaction.dedup_rows(
            st.store, D, R, floor, self._plain_sort)
        return (
            dataclasses.replace(st, store=store, store_len=Lc,
                                distinct=drows),
            drows,
        )

    def _ensure_capacity(self, st):
        """(state, host distinct vector) with the capacity contract
        checked against EXACT distinct (cross-row dedup on demand)."""
        d = host_distinct(st.distinct)
        if (st.store is not None
                and self._distinct_total(d) > self.cfg.sparse_capacity):
            st, d = self._dedup_state(st)
        self._check_capacity(self._distinct_total(d))
        return st, d

    def _check_capacity(self, distinct: int):
        if distinct > self.cfg.sparse_capacity:
            D, _, _ = self._dedup_geometry()
            where = " on one device" if D > 1 else ""
            raise RuntimeError(
                f"sparse store exceeded sparse_capacity "
                f"({distinct} > {self.cfg.sparse_capacity} distinct "
                f"k-mers{where}); raise Config.sparse_capacity or set "
                "--spill"
            )

    def _store_table(self, st, d):
        """(state, SparseTable) of a row store squeezed to its live
        ladder (the state keeps the squeezed store)."""
        _, _, floor = self._dedup_geometry()
        Ld = sparse_ops.ladder(max(int(np.asarray(d).max()), 1),
                               floor=floor)
        store, cols = st.store, st.store_len
        if cols > Ld:
            store = compaction.squeeze_slice(store, Ld, self._plain_sort)
            cols = Ld
        st = dataclasses.replace(st, store=store, store_len=cols,
                                 distinct=np.asarray(d))
        return st, table_mod.SparseTable(
            codes=store[0], counts=store[1], k=self.cfg.k)

    def _restore_planes(self, table):
        """A sparse table from any engine -> ((codes, counts) store on
        this counter's device, Lc, per-row distinct), re-dealt as D * R
        contiguous sorted rows of one merged distinct run, so that rows
        hold globally disjoint code ranges."""
        D, R, floor = self._dedup_geometry()
        G = D * R
        codes, counts = merge_host_entries(
            *table_entries(table, self.cfg.k))
        n = codes.size
        Lc = sparse_ops.ladder(-(-n // G) if n else 1, floor=floor)
        cdt = code_dtype(self.cfg.k)
        plane = torch.full((G * Lc,), sentinel(cdt), dtype=cdt)
        plane[:n] = torch.from_numpy(codes.astype(np.int64))
        cnt = torch.zeros(G * Lc, dtype=table_mod.count_dtype(self.cfg))
        cnt[:n] = torch.from_numpy(counts)
        drows = np.bincount(np.arange(n) // Lc, minlength=G).astype(np.int64)
        store = (plane.reshape(G, Lc).to(self.device),
                 cnt.reshape(G, Lc).to(self.device))
        return store, Lc, drows


def host_distinct(d) -> np.ndarray:
    """A per-row distinct vector (device tensor, numpy or scalar) on the
    host.  A device tensor waits for the compaction that made it."""
    if isinstance(d, torch.Tensor):
        return d.cpu().numpy()
    return np.asarray(d)
