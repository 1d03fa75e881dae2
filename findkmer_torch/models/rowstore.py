"""Raw-buffer growth and the row store's capacity, dedup and table logic.

Counterpart of `findkmer_tpu/models/rowstore.py` for the single-device
engine.  The geometry contract is the JAX package's: a store is
(D * R, L), D device groups of R rows (one device: D = 1, R = G), and
`distinct` is the per-row distinct vector of the last compaction.  The
capacity metric is the largest per-group sum, because sparse_capacity
bounds the DISTINCT k-mers resident on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from findkmer_torch import spill
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


def table_entries(table, k: int):
    """Any sparse table's entries as flat tensors (codes, counts), repeats
    possible; slots with count 0 are dead, whatever their code.  Takes the
    port's SparseTable (codes, counts), as it is, or one with host planes
    (hi, lo, cnt), such as the JAX counter's `table_state` or a loaded
    checkpoint: its codes are (hi << 32) | lo, and its sentinels and holes
    are stripped here BY COUNT (a real k >= 16 code can have lo =
    0xFFFFFFFF), so only live entries are widened."""
    if table.k != k:
        raise ValueError(f"table is for k={table.k}, counter for k={k}")
    if hasattr(table, "codes"):
        return (torch.as_tensor(table.codes).reshape(-1),
                torch.as_tensor(table.counts).reshape(-1))
    cnt = np.asarray(table.cnt)
    live = cnt > 0
    codes = np.asarray(table.lo)[live].astype(np.int64)
    if k > 15:
        codes |= np.asarray(table.hi)[live].astype(np.int64) << 32
    return torch.from_numpy(codes), torch.from_numpy(cnt[live])


class RowStoreMixin:
    """Capacity / dedup / table logic of the sparse engine.

    Subclass contract: `self.cfg`, `self.device`, `self._plain_sort`,
    `self._spill_n` (spill runs written so far) and
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
        if self.cfg.spill_dir:
            return  # spilling bounds the store instead of erroring
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
        hold globally disjoint code ranges.  The live entries merge on the
        device (`global_compact`: one flat sort), where they are bound
        anyway."""
        D, R, floor = self._dedup_geometry()
        G = D * R
        cdt = code_dtype(self.cfg.k)
        codes, counts = table_entries(table, self.cfg.k)
        codes, counts = sparse_ops.global_compact(
            codes.to(self.device, cdt),
            counts.to(self.device, table_mod.count_dtype(self.cfg)))
        n = codes.numel()
        Lc = sparse_ops.ladder(-(-n // G) if n else 1, floor=floor)
        plane = fresh_raw(G * Lc, cdt, self.device)
        plane[:n] = codes
        cnt = torch.zeros(G * Lc, dtype=counts.dtype, device=self.device)
        cnt[:n] = counts
        # row g holds entries [g * Lc, (g + 1) * Lc) of the n merged ones
        drows = np.clip(n - np.arange(G, dtype=np.int64) * Lc, 0, Lc)
        return (plane.reshape(G, Lc), cnt.reshape(G, Lc)), Lc, drows

    def adopt_spill_runs(self, n_runs: int, token: str | None = None):
        """Checkpoint-resume adoption of disk-spill runs.

        The checkpoint manifest records how many spill runs belong to
        its prefix (streaming.py); runs past that index were written by
        a later, crashed stream whose batches will be REPLAYED: they are
        deleted here, or the spectrum would count them twice.  Fewer runs
        than the manifest promises is unrecoverable.

        `token` is the stream-identity token the checkpoint recorded
        (spill.write_token at init_dir time): any run files present when
        it does NOT match the dir's token belong to a DIFFERENT count.
        Adopting them would corrupt the spectrum and deleting them would
        destroy someone else's crash state, so both are refused."""
        if n_runs and not self.cfg.spill_dir:
            raise ValueError(
                f"checkpoint recorded {n_runs} spill runs but --spill "
                "is off; rerun with the original --spill DIR"
            )
        if not self.cfg.spill_dir:
            return
        have = len(spill.load_runs(self.cfg.spill_dir))
        dir_token = spill.read_token(self.cfg.spill_dir)
        same = (
            token is not None and dir_token is not None
            and token == dir_token
        )
        # state from before the tokens existed (neither side has an
        # identity) with an EXACT run-count match resumes as it did then:
        # the guard stops adopting or deleting a DIFFERENT count's runs,
        # it must not strand old checkpoints
        legacy_exact = (
            token is None and dir_token is None and have == n_runs
        )
        if (have or n_runs) and not (same or legacy_exact):
            raise RuntimeError(
                f"spill dir {self.cfg.spill_dir!r} holds run files "
                "from a different stream than this checkpoint "
                "(identity token mismatch); refusing to adopt or "
                "delete them — resume with the original --spill DIR, "
                "or point --spill at an empty directory"
            )
        if have < n_runs:
            raise RuntimeError(
                f"checkpoint expects {n_runs} spill runs in "
                f"{self.cfg.spill_dir!r} but only {have} exist; the "
                "spill dir was truncated — restart the count"
            )
        if have > n_runs:
            spill.remove_runs_from(self.cfg.spill_dir, n_runs)
        if dir_token is None:
            # resumed into a fresh dir (no runs yet): re-stamp the
            # stream's identity so later checkpoints stay consistent
            spill.write_token(self.cfg.spill_dir, token)
        self._spill_n = n_runs


def host_distinct(d) -> np.ndarray:
    """A per-row distinct vector (device tensor, numpy or scalar) on the
    host.  A device tensor waits for the compaction that made it."""
    if isinstance(d, torch.Tensor):
        return d.cpu().numpy()
    return np.asarray(d)
