"""Counting over a mesh of shards: the port's DistributedCounter.

Counterpart of `findkmer_tpu/parallel/dist.py`, with the same counter
interface as `models/counter.KmerCounter` (`init_state` / `step` /
`flush` / `finalize` / `finalize_chunks` / `put_batch` / `table_state` /
`restore_state`), so that the host layer drives either alike.  The
reference runs one `shard_map` program over a 1-D mesh; the port runs one
process over a list of shards (`parallel/mesh.py`), each on its own
`torch.device`.  A global (B, R) batch is cut into n row blocks, block i
to shard i (B % n == 0); what the reference's collectives move, the port
moves with copies between the shards' devices.

Four merge strategies, resolved from Config.merge as the reference does
(auto: all_to_all for a direct table at k > 10 on more than one shard,
else psum; a sparse table is always dp_sparse):

  * psum: each shard adds its rows into a full (4^k,) partial table (the
    single-device dense step: K2 from the wire on a card); finalize sums
    the partials.  No exchange per batch.
  * psum_scatter: the same step; finalize gives shard j the sum of every
    partial's j-th 4^k/n slice (a reduce-scatter), then joins the slices.
  * all_to_all: the table is split into n contiguous shards by code
    prefix.  Each shard extracts its rows' codes, stably sorts them by
    owner (code >> shift) into (n, cap) buckets, dropping what overflows
    a bucket and raising the overflow flag; bucket j goes to shard j,
    which adds what it receives into its slice.  Plain torch: the
    reference leaves this step to XLA.
  * dp_sparse: each shard keeps a raw code buffer and a row store of
    `sub` rows (the compaction chain of `ops/compaction.py`, whose row
    sort is K3), spills one run per shard, and the finalize merges one
    sorted run per shard on the host (`merge_host_runs`).

The shard geometry (`_sub_rows`, `_raw_cap0`, `_target_cap`, the dedup's
common column count) is the reference's, so compactions and spills happen
at the same batches, and `count --spill` writes the same number of runs.
"""

from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from findkmer_torch import spill
from findkmer_torch import table as table_mod
from findkmer_torch.config import Config
from findkmer_torch.models import counter as counter_mod
from findkmer_torch.models import rowstore
from findkmer_torch.models.rowstore import RowStoreMixin
from findkmer_torch.ops import compaction
from findkmer_torch.ops import sparse as sparse_ops
from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda.histogram_kernel import MAX_K
from findkmer_torch.parallel.mesh import Mesh, make_mesh
from findkmer_torch.utils.prof import phases

# column floor of the dp_sparse store (the reference's _dedup_geometry)
COL_FLOOR = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _sub_rows(cap0: int) -> int:
    """Row count of each shard's store: the reference's geometry rule
    (`compaction.row_geometry` from one row), so a shard's compaction
    sorts short rows."""
    return compaction.row_geometry(cap0, g0=1)


def _on(device: torch.device):
    """Make `device` current for the kernels launched inside (a launch
    goes to the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _joined_on_host(parts) -> np.ndarray:
    """Tensors of one dtype (on any devices), end to end in one new host
    array: one copy each, no second pass to join them."""
    out = torch.empty(sum(p.numel() for p in parts), dtype=parts[0].dtype)
    at = 0
    for p in parts:
        out[at : at + p.numel()].copy_(p.reshape(-1))
        at += p.numel()
    return out.numpy()


class ShardedBatch(list):
    """One global batch as its per-shard parts (part i on shard i's
    device), each a (B/n, R) row tensor or a (packed, validbits) pair.
    `staged`, while set, holds the pinned stager's copies still in flight
    (`pipeline._PinnedStager.take` makes the compute streams wait)."""

    staged = None


@dataclass
class DpSparseState:
    """Per-shard log-structured sparse state.

    raw:   one (cap,) sentinel-filled code buffer per shard; `fill` is the
           same on every shard and tracked on the host.
    store: one (codes, counts) (sub, store_len) row store per shard, or
           None before the first compaction.
    distinct: the per-row distinct counts of the last compaction, one
           (sub,) tensor per shard (read on the host at the next
           compaction), or one host vector of n * sub."""

    raw: List[torch.Tensor]
    fill: int = 0
    store: Optional[list] = None
    store_len: int = 0
    distinct: object = None


class DistributedCounter(RowStoreMixin):
    """Mesh-parallel counter.  Feed global (B, R) batches; B % n == 0.

    `table_entries` (all_to_all only) scales the sharded table for dry
    runs and tests: codes route with the production geometry (owner =
    code >> shift, shift derived from the scaled shard), but the table
    holds only the first `table_entries` codes; codes past it route to
    shards that do not exist and are dropped, so counts are PARTIAL.
    None (production) is the full 4^k table.

    `row_sort` and `dense_kernel` pick the shards' kernels, as for
    `KmerCounter`."""

    # batches between host checks of the route-overflow flag: a skewed
    # input fails within this many batches, not at the finalize
    overflow_check_every = 64

    def __init__(self, cfg: Config, mesh: Optional[Mesh] = None, *,
                 table_entries: Optional[int] = None,
                 row_sort: str = "auto", dense_kernel: str = "fused"):
        self.cfg = cfg
        self.mesh = list(mesh) if mesh is not None else make_mesh()
        self.n_dev = len(self.mesh)
        self.device = self.mesh[0]
        self.mode = cfg.resolved_table_mode
        if row_sort not in counter_mod.ROW_SORTS:
            raise ValueError(
                f"row_sort must be one of {counter_mod.ROW_SORTS}, got "
                f"{row_sort!r}"
            )
        self._plain_sort = row_sort == "plain" or (
            row_sort == "auto" and self.device.type != "cuda"
        )
        if table_entries is not None and (
            table_entries & (table_entries - 1) or table_entries <= 0
        ):
            raise ValueError("table_entries must be a power of two")
        self._table_entries = table_entries
        if cfg.batch_rows % self.n_dev != 0:
            raise ValueError(
                f"batch_rows ({cfg.batch_rows}) must be divisible by the "
                f"mesh size ({self.n_dev})"
            )
        merge = cfg.merge
        if merge == "auto":
            # route when the table is too big to replicate comfortably
            merge = (
                "all_to_all"
                if (self.mode == "direct" and cfg.k > 10 and self.n_dev > 1)
                else "psum"
            )
        if self.mode == "sparse":
            merge = "dp_sparse"
        self.merge = merge
        self._spill_n = 0
        if cfg.spill_dir:
            if merge != "dp_sparse":
                raise ValueError(
                    "--spill requires a sparse table "
                    f"(k={cfg.k} resolves to a dense merge)"
                )
            # stale runs are refused in init_state (a fresh count) or
            # adopt_spill_runs (a checkpoint resume), not here
            os.makedirs(cfg.spill_dir, exist_ok=True)
        if merge == "all_to_all":
            if self.table_size % self.n_dev != 0:
                raise ValueError(
                    f"table size 4^{cfg.k} not divisible by {self.n_dev} "
                    "devices (use a power-of-two mesh)"
                )
            if self.n_dev & (self.n_dev - 1):
                raise ValueError("all_to_all merge needs power-of-two mesh")
        elif self._table_entries is not None:
            raise ValueError(
                "table_entries scaling applies to all_to_all merge only"
            )
        self._steps_since_check = 0
        if merge in ("psum", "psum_scatter"):
            if merge == "psum_scatter" and cfg.table_size % self.n_dev:
                raise ValueError(
                    f"psum_scatter needs table size 4^{cfg.k} divisible "
                    f"by {self.n_dev} devices (use a power-of-two mesh)"
                )
            # each shard's step is the single-device dense step; the
            # reference's mesh step takes XLA's scatter for any --hist,
            # so a kernel the k is too large for gives way to it here too
            shard_cfg = cfg.replace(devices=1)
            if cfg.hist == "pallas" and cfg.k > MAX_K:
                shard_cfg = shard_cfg.replace(hist="scatter")
            self._engines = [
                counter_mod.KmerCounter(shard_cfg, d,
                                        dense_kernel=dense_kernel)
                for d in self.mesh
            ]
        elif merge == "all_to_all":
            T = self.table_size
            self._shard_size = T // self.n_dev
            self._shift = int(math.log2(self._shard_size))
            w_local = (cfg.batch_rows // self.n_dev) * cfg.window_len
            # canonical folding maps every window to min(code, revcomp):
            # codes concentrate in the lower half of code space, so
            # low-prefix shards see ~2x the average traffic
            skew = 2.0 if cfg.canonical else 1.0
            self._route_cap = _round_up(
                int(w_local / self.n_dev * cfg.route_capacity_factor * skew)
                + 8, 8)
        elif merge == "dp_sparse":
            self._code_dtype = window_ops.code_dtype(cfg.k)
            self._w_local = (cfg.batch_rows // self.n_dev) * cfg.window_len
            # each shard's raw buffer re-splits into `sub` short rows at
            # every compaction (the reference's per-device geometry)
            self._sub = _sub_rows(self._raw_cap0())
        else:
            raise ValueError(f"unknown merge strategy {merge!r}")

    @property
    def table_size(self) -> int:
        """Dense-table entries (scaled in dry runs, see the class doc)."""
        if self._table_entries is not None:
            return self._table_entries
        return self.cfg.table_size

    # ------------------------------------------------------------------
    def init_state(self):
        cfg = self.cfg
        cdt = table_mod.count_dtype(cfg)
        if self.merge in ("psum", "psum_scatter"):
            return [e.init_state() for e in self._engines]
        if self.merge == "all_to_all":
            shards = [torch.zeros(self._shard_size, dtype=cdt, device=d)
                      for d in self.mesh]
            return (shards, self._no_overflow())
        if self._spill_n:
            raise RuntimeError(
                "this counter already spilled runs for a previous "
                "state; use a fresh counter (and an empty spill dir) "
                "per count"
            )
        if cfg.spill_dir:
            spill.init_dir(cfg.spill_dir)  # refuses stale runs
        return DpSparseState(raw=self._fresh_raw(self._raw_cap0()))

    def _no_overflow(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.bool, device=self.device)

    # --- batches ------------------------------------------------------
    def put_batch(self, batch) -> ShardedBatch:
        """Host batch (rows, or a (packed, validbits) pair) -> its row
        blocks on the shards' devices.  On CUDA the batch goes through
        pinned host memory and side-stream copies (`pipeline.
        _PinnedStager`); the step that takes it waits for them."""
        self._check_rows(batch)
        if self.device.type != "cuda":
            return self._split(batch)
        from findkmer_torch.pipeline import _PinnedStager

        stager = getattr(self, "_stager", None)
        if stager is None:
            stager = self._stager = _PinnedStager(
                self.cfg.prefetch + 1, self.device, shards=self.mesh)
        parts, events = stager.put(batch)
        out = ShardedBatch(parts)
        out.staged = (stager, parts, events)
        return out

    def _check_rows(self, batch) -> None:
        nrows = (batch[0] if isinstance(batch, (tuple, list))
                 else batch).shape[0]
        if nrows % self.n_dev:
            # a sub-batch-rows input shrank its only batch (the tail
            # shrink is gated on Config.devices == 1)
            raise ValueError(
                f"batch of {nrows} rows is not divisible by the "
                f"{self.n_dev}-device mesh; set Config.devices to the "
                "mesh width so the batcher keeps shard-compatible shapes"
            )

    def _split(self, batch) -> ShardedBatch:
        """Row blocks of a batch (numpy or tensors) on the shards'
        devices."""
        arrs = tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)
        b = arrs[0].shape[0] // self.n_dev
        parts = []
        for i, dev in enumerate(self.mesh):
            ts = tuple(torch.as_tensor(a[i * b : (i + 1) * b]).to(dev)
                       for a in arrs)
            parts.append(ts if len(ts) > 1 else ts[0])
        return ShardedBatch(parts)

    def _parts(self, rows) -> ShardedBatch:
        """A step's batch as its shards' parts, ready on their devices:
        a ShardedBatch of put_batch, or a host batch (placed here), or
        tensors (split here)."""
        if not isinstance(rows, ShardedBatch):
            host = isinstance(rows, np.ndarray) or (
                isinstance(rows, (tuple, list))
                and isinstance(rows[0], np.ndarray))
            if host:
                rows = self.put_batch(rows)
            else:
                self._check_rows(rows)
                rows = self._split(rows)
        if rows.staged is not None:
            stager, parts, events = rows.staged
            stager.take((parts, events))
            rows.staged = None
        return rows

    # --- the step -----------------------------------------------------
    def step(self, state, rows):
        parts = self._parts(rows)
        if self.merge in ("psum", "psum_scatter"):
            for e, t, part, dev in zip(self._engines, state, parts,
                                       self.mesh):
                with _on(dev):
                    e.step(t, part)
            return state
        if self.merge == "all_to_all":
            return self._route_step(state, parts)
        return self._sparse_step(state, parts)

    def _route_step(self, state, parts):
        shards, overflow = state
        T, cap = self.table_size, self._route_cap
        buckets = []
        for part, dev in zip(parts, self.mesh):
            with _on(dev):
                b, ovf = self._buckets(part, dev, T, cap)
            buckets.append(b)
            overflow = overflow | ovf.to(self.device)
        S = self._shard_size
        for j, (shard, dev) in enumerate(zip(shards, self.mesh)):
            with _on(dev):
                # bucket j of every shard, on shard j's device
                recv = torch.stack([b[j].to(dev) for b in buckets])
                local = recv.reshape(-1) - j * S
                keep = (local >= 0) & (local < S)
                # the reference's scatter drops what lies outside the
                # shard (sentinels, codes past a scaled table); here a
                # dropped entry adds 0 at a clamped index (no host sync)
                shard.index_add_(0, local.clamp_(0, S - 1),
                                 keep.to(shard.dtype))
        self._steps_since_check += 1
        if self._steps_since_check >= self.overflow_check_every:
            self._steps_since_check = 0
            self._raise_if_overflowed(overflow)
        return (shards, overflow)

    def _buckets(self, part, dev, T: int, cap: int):
        """One shard's rows -> its (n, cap) buckets by owner shard, and
        whether a bucket overflowed.  Slots past a bucket's fill are the
        sentinel T (outside every shard)."""
        cfg, n = self.cfg, self.n_dev
        rows = window_ops.rows_from_batch(part, cfg.row_len)
        codes, valid = window_ops.window_codes(rows, cfg.k, cfg.canonical)
        flat = torch.where(valid, codes, T).reshape(-1)
        dest = flat >> self._shift  # invalid -> n (dropped)
        dest_s, order = torch.sort(dest, stable=True)
        flat_s = flat[order]
        del order
        start = torch.searchsorted(
            dest_s, torch.arange(n, dtype=dest_s.dtype, device=dev))
        offs = torch.arange(flat_s.numel(), dtype=torch.int64, device=dev)
        offs -= start[dest_s.clamp(0, n - 1)]
        routed = dest_s < n
        ovf = torch.any((offs >= cap) & routed)
        keep = routed & (offs < cap)
        # one flat (n * cap + 1) buffer: what is not kept lands in the
        # last slot, cut off below
        slot = torch.where(keep, dest_s.to(torch.int64) * cap + offs,
                           n * cap)
        buf = torch.full((n * cap + 1,), T, dtype=flat.dtype, device=dev)
        buf.scatter_(0, slot, flat_s)
        return buf[: n * cap].view(n, cap), ovf

    def _raise_if_overflowed(self, overflow) -> None:
        if bool(overflow):
            raise RuntimeError(
                "all_to_all route bucket overflowed "
                f"(capacity {self._route_cap}); raise "
                "Config.route_capacity_factor (skewed input)"
            )

    def _sparse_step(self, st: DpSparseState, parts):
        cfg = self.cfg
        # slots per shard, from shapes (may exceed w_local: packed slot
        # padding)
        n = counter_mod.batch_slots(parts[0], cfg.k, cfg.row_len)
        cap = st.raw[0].shape[0]
        target = self._target_cap()
        raw, fill = st.raw, st.fill
        if fill + n > cap:
            if fill + n > target:
                st = self._compact_sparse(st)
                raw, fill = st.raw, 0
                cap = raw[0].shape[0]
            while fill + n > cap:
                cap = sparse_ops.ladder(max(fill + n, 2 * cap), floor=4096)
                raw = [rowstore.grow_raw(r, cap) for r in raw]
        for r, part, dev in zip(raw, parts, self.mesh):
            with _on(dev):
                counter_mod.ingest(r[fill : fill + n], part, cfg.k,
                                   cfg.canonical, cfg.row_len)
        return replace(st, raw=raw, fill=fill + n)

    # --- dp_sparse geometry (the reference's) -------------------------
    def _raw_cap0(self) -> int:
        if self.cfg.sparse_expected_entries:
            want = max(self.cfg.sparse_expected_entries // self.n_dev,
                       2 * self._w_local)
        else:
            want = 2 * self._w_local
        return sparse_ops.ladder(min(want, self._target_cap()), floor=4096)

    def _target_cap(self) -> int:
        # per-shard compaction threshold: the configured TOTAL raw
        # entries split across the shards
        per_dev = max(self.cfg.sparse_compact_entries // self.n_dev,
                      self._w_local)
        return sparse_ops.ladder(per_dev, floor=4096)

    def _fresh_raw(self, cap: int) -> List[torch.Tensor]:
        return [rowstore.fresh_raw(cap, self._code_dtype, d)
                for d in self.mesh]

    def _dedup_geometry(self):
        """n shard groups of `sub` rows; sparse_capacity bounds the
        distinct k-mers of one shard (models/rowstore.py contract)."""
        return self.n_dev, self._sub, COL_FLOOR

    def _host_d(self, distinct) -> np.ndarray:
        if isinstance(distinct, list):
            return np.concatenate([rowstore.host_distinct(t)
                                   for t in distinct])
        return np.asarray(distinct)

    def _compact_raw(self, raw, cap: int):
        """First compaction of every shard: (store list, distinct
        list)."""
        R, cdt = self._sub, table_mod.count_dtype(self.cfg)
        L = sparse_ops.ladder(cap // R, floor=COL_FLOOR)
        store, distinct = [], []
        for r, dev in zip(raw, self.mesh):
            with _on(dev):
                s, d = compaction.compact_raw_rows(r, R, L, cdt,
                                                   self._plain_sort)
            store.append(s)
            distinct.append(d)
        return store, L, distinct

    def _compact_sparse(self, st: DpSparseState) -> DpSparseState:
        if st.fill == 0 and st.store is not None:
            return st
        cap = st.raw[0].shape[0]
        R = self._sub
        if st.store is None:
            store, L, distinct = self._compact_raw(st.raw, cap)
            return DpSparseState(raw=self._fresh_raw(cap), fill=0,
                                 store=store, store_len=L,
                                 distinct=distinct)
        dv = self._host_d(st.distinct)  # the previous compaction's
        if self._distinct_total(dv) > self.cfg.sparse_capacity:
            # the sum counts store ENTRIES; only the exact distinct
            # count may decide a spill or the capacity error
            st, dv = self._dedup_state(st)
        d = self._distinct_total(dv)
        if self.cfg.spill_dir and d > self.cfg.sparse_capacity:
            # per-shard disk spill: one run per shard, then the stores
            # restart from the raw buffers alone
            self._spill_stores(st.store, dv)
            store, L, distinct = self._compact_raw(st.raw, cap)
            return DpSparseState(raw=self._fresh_raw(cap), fill=0,
                                 store=store, store_len=L,
                                 distinct=distinct)
        self._check_capacity(d)
        store, store_len = st.store, st.store_len
        Ld = sparse_ops.ladder(int(dv.max()), floor=COL_FLOOR)
        if store_len > 2 * Ld:
            # hole fraction > 1/2: squeeze rows before re-sorting
            store = [self._squeeze(s, Ld, dev)
                     for s, dev in zip(store, self.mesh)]
            store_len = Ld
        L = sparse_ops.ladder(store_len + cap // R, floor=COL_FLOOR)
        new_store, distinct = [], []
        for s, r, dev in zip(store, st.raw, self.mesh):
            with _on(dev):
                s2, d2 = compaction.compact_counted_rows(
                    s, r, R, L, self._plain_sort)
            new_store.append(s2)
            distinct.append(d2)
        return DpSparseState(raw=self._fresh_raw(cap), fill=0,
                             store=new_store, store_len=L,
                             distinct=distinct)

    def _squeeze(self, store, Ld: int, dev):
        with _on(dev):
            return compaction.squeeze_slice(store, Ld, self._plain_sort)

    def _dedup_state(self, st: DpSparseState):
        """Cross-row dedup within each shard (`compaction.dedup_rows`
        per group): one flat sort of the shard's rows, then its sorted
        distinct entries re-dealt into `sub` rows of a column count
        common to all shards (the reference's one (n * sub, Lc) store).
        -> (state, exact per-row distinct on the host)."""
        sub = self._sub
        folded = []
        for (codes, cnt), dev in zip(st.store, self.mesh):
            with _on(dev):
                c, n, d = sparse_ops.compact_counted_2d(
                    codes.reshape(1, -1), cnt.reshape(1, -1),
                    self._plain_sort)
            folded.append((c, n, int(d.max())))
        dmax = max(d for _, _, d in folded)
        Lc = sparse_ops.ladder(max(-(-dmax // sub), 1), floor=COL_FLOOR)
        store = []
        for (c, n, _), dev in zip(folded, self.mesh):
            c, n = self._squeeze((c, n), sub * Lc, dev)
            store.append((c.reshape(sub, Lc), n.reshape(sub, Lc)))
        drows = np.concatenate([
            torch.count_nonzero(n, dim=1).cpu().numpy() for _, n in store
        ]).astype(np.int64)
        return replace(st, store=store, store_len=Lc, distinct=drows), drows

    def _ensure_capacity(self, st: DpSparseState):
        d = self._host_d(st.distinct)
        if (st.store is not None
                and self._distinct_total(d) > self.cfg.sparse_capacity):
            st, d = self._dedup_state(st)
        self._check_capacity(self._distinct_total(d))
        return st, d

    def _shard_runs(self, store, d):
        """Each shard's store as one sorted distinct host run (codes
        uint64, counts int64): one flat sort of the shard on its device
        (`global_compact`), then the pull.  -> [(shard, codes, counts)]
        of the shards that hold any entry."""
        sub = self._sub
        runs = []
        for i, (s, dev) in enumerate(zip(store, self.mesh)):
            if not int(d[i * sub : (i + 1) * sub].sum()):
                continue
            with _on(dev):
                codes, counts = counter_mod._pull_owned(
                    *sparse_ops.global_compact(*s))
            runs.append((i, codes, counts))
        return runs

    def _spill_stores(self, store, d) -> None:
        """Persist ONE spill run per shard that holds entries, so the
        spill-run count stays O(n) for the finalize's k-way merge."""
        for _, codes, counts in self._shard_runs(store, d):
            spill.write_run(self.cfg.spill_dir, self._spill_n, codes,
                            counts)
            self._spill_n += 1

    def flush(self, state):
        """Force a sparse compaction (no-op for the dense merges, whose
        batches are already in their tables)."""
        if self.merge == "dp_sparse":
            return self._compact_sparse(state)
        return state

    # ------------------------------------------------------------------
    def _sum_partials(self, tables) -> torch.Tensor:
        """The partials' sum on the first shard's device, as a new
        tensor (the state keeps stepping after a checkpoint)."""
        total = tables[0].counts.clone()
        for t in tables[1:]:
            total += t.counts.to(self.device)
        return total

    def _scatter_partials(self, tables) -> List[torch.Tensor]:
        """Reduce-scatter: shard j gets the sum of every partial's j-th
        4^k/n slice, on its own device."""
        S = self.cfg.table_size // self.n_dev
        out = []
        for j, dev in enumerate(self.mesh):
            part = tables[j].counts[j * S : (j + 1) * S].clone()
            for i, t in enumerate(tables):
                if i != j:
                    part += t.counts[j * S : (j + 1) * S].to(dev)
            out.append(part)
        return out

    def finalize(self, state, timers=None):
        """Mesh state -> the host spectrum (dense np (4^k,) counts, or
        sparse (codes uint64, counts int64): one `gather` of the chunks
        `finalize_chunks` yields).  `timers` gets the same finalize
        phases as the single-device engine's."""
        ph = phases(timers)
        if self.merge == "psum":
            with ph("finalize/merge"):
                return self._sum_partials(state).cpu().numpy()
        if self.merge == "psum_scatter":
            with ph("finalize/merge"):
                return _joined_on_host(self._scatter_partials(state))
        if self.merge == "all_to_all":
            shards, overflow = state
            self._raise_if_overflowed(overflow)
            with ph("finalize/merge"):
                return _joined_on_host(shards)
        return counter_mod.gather(*self._store_chunks(state, ph), ph=ph)

    def _store_chunks(self, state, ph):
        """(sorted distinct host chunks, None: their count is not known
        before the pull) of the dp_sparse stores, compacted first: the
        streaming k-way merge of the disk runs (when any were written)
        and the per-shard runs (`spill.iter_merged`), or the heap-merge
        finalize's one chunk under FINDKMER_ORDERED_FINALIZE=0.  Every
        chunk is an array of its own."""
        with ph("finalize/compact"):
            st = self._compact_sparse(state)
            st, d = self._ensure_capacity(st)
        if self._spill_n:
            return self._merged_spill_chunks(st, d), None
        if os.environ.get("FINDKMER_ORDERED_FINALIZE", "1") != "1":
            return [self._finalize_heap_merge(st, d, ph)], None
        with ph("finalize/d2h"):
            runs = [(c, n) for _, c, n in self._shard_runs(st.store, d)]
        return spill.iter_merged(runs), None

    def _finalize_heap_merge(self, st: DpSparseState, d, ph):
        """The heap-merge finalize (FINDKMER_ORDERED_FINALIZE=0): every
        shard's store squeezed to the live ladder, pulled as it is, and
        its n * sub rows merged on the host in one C pass."""
        Ld = sparse_ops.ladder(int(d.max()), floor=4096)
        planes = []
        with ph("finalize/squeeze"):
            for (codes, cnt), dev in zip(st.store, self.mesh):
                if st.store_len > Ld:
                    # the squeeze sorts the counts in place: a copy, so
                    # that finalize leaves the state as it was
                    codes, cnt = self._squeeze((codes, cnt.clone()), Ld,
                                               dev)
                planes.append((codes, cnt))
        with ph("finalize/d2h"):
            codes = _joined_on_host([c for c, _ in planes])
            cnt = _joined_on_host([n for _, n in planes])
        width = planes[0][0].shape[1]
        codes, cnt = codes.reshape(-1, width), cnt.reshape(-1, width)
        with ph("finalize/merge"):
            return sparse_ops.store_to_host_2d(codes, cnt)

    def _merged_spill_chunks(self, st: DpSparseState, d):
        """Streaming k-way merge of the disk runs and the residual shard
        runs; yields sorted distinct host chunks, then deletes the
        consumed run files (finalizing spilled state twice is an
        error)."""
        runs = spill.load_runs(self.cfg.spill_dir)
        if not runs:
            raise RuntimeError(
                "spill runs missing (already consumed by a previous "
                "finalize, or deleted); rerun the count"
            )
        runs.extend((c, n) for _, c, n in self._shard_runs(st.store, d))
        yield from spill.iter_merged(runs)
        spill.remove_runs(self.cfg.spill_dir)  # consumed; free the disk

    def finalize_chunks(self, state, timers=None):
        """The spectrum as host (codes uint64, counts int64) chunks in
        code order, what `output.write_spectrum` writes: the dp_sparse
        stores' (`_store_chunks`); a dense merge's table, the partials
        summed (psum) or its shards, each from its own code offset
        (psum_scatter, all_to_all), through `models/counter.
        _table_chunks`: the nonzero bins, or with cfg.zeros every bin."""
        cfg = self.cfg
        if self.merge == "psum":
            yield from counter_mod._table_chunks(self._sum_partials(state),
                                                 cfg.zeros)
            return
        if self.merge in ("psum_scatter", "all_to_all"):
            if self.merge == "psum_scatter":
                shards = self._scatter_partials(state)
            else:
                shards, overflow = state
                self._raise_if_overflowed(overflow)
            for j, shard in enumerate(shards):
                yield from counter_mod._table_chunks(
                    shard, cfg.zeros, offset=j * shard.numel())
            return
        counter_mod._refuse_sparse_zeros(cfg)
        yield from self._store_chunks(state, phases(timers))[0]

    # ------------------------------------------------------------------
    # checkpoint / resume (utils/checkpoint.py via streaming.py)
    def table_state(self, state):
        """(state, checkpointable table).

        Counting is associative, so the mesh state reduces to one
        portable table: the dense merges checkpoint the MERGED (4^k,)
        table (partials summed; all_to_all's disjoint shards joined),
        dp_sparse its compacted stores as one SparseTable of n * sub
        rows, the same layout as the single-device store's.
        restore_state redistributes onto any mesh width."""
        cfg = self.cfg
        if self.merge in ("psum", "psum_scatter"):
            return state, table_mod.DenseTable(
                counts=self._sum_partials(state), k=cfg.k)
        if self.merge == "all_to_all":
            shards, overflow = state
            # one scalar to the host a checkpoint: never persist
            # overflowed (silently incomplete) state
            self._raise_if_overflowed(overflow)
            return state, table_mod.DenseTable(
                counts=torch.cat([s.to(self.device) for s in shards]),
                k=cfg.k)
        st = self._compact_sparse(state)
        st, d = self._ensure_capacity(st)
        Ld = sparse_ops.ladder(max(int(d.max()), 1), floor=COL_FLOOR)
        store, cols = st.store, st.store_len
        if cols > Ld:
            store = [self._squeeze(s, Ld, dev)
                     for s, dev in zip(store, self.mesh)]
            cols = Ld
        st = replace(st, store=store, store_len=cols, distinct=d)
        return st, table_mod.SparseTable(
            codes=torch.cat([c.to(self.device) for c, _ in store]),
            counts=torch.cat([n.to(self.device) for _, n in store]),
            k=cfg.k)

    def restore_state(self, table):
        """Mesh step state from a checkpointed table of any engine and
        mesh width (elastic resume).

        Dense: the (4^k,) totals land on the first shard's partial
        (psum merges) or re-shard by code prefix (all_to_all).
        dp_sparse: the table's entries merge to one sorted distinct run,
        dealt out as n * sub contiguous sorted rows, `sub` to a shard."""
        cfg, n = self.cfg, self.n_dev
        if table.k != cfg.k:
            raise ValueError(
                f"table is for k={table.k}, counter for k={cfg.k}"
            )
        cdt = table_mod.count_dtype(cfg)
        if self.merge in ("psum", "psum_scatter", "all_to_all"):
            counts = table.counts
            if not isinstance(counts, torch.Tensor):
                counts = torch.from_numpy(np.asarray(counts))
            T = self.table_size
            if tuple(counts.shape) != (T,):
                raise ValueError(
                    f"checkpoint table has shape {tuple(counts.shape)}, "
                    f"expected ({T},) for k={cfg.k}"
                )
            if self.merge == "all_to_all":
                S = T // n
                shards = [counts[j * S : (j + 1) * S].to(dev, cdt,
                                                         copy=True)
                          for j, dev in enumerate(self.mesh)]
                return (shards, self._no_overflow())
            state = self.init_state()
            state[0].counts.copy_(counts.to(self.device, cdt))
            return state
        (codes, cnt), Lc, drows = self._restore_planes(table)
        sub = self._sub
        store = [(codes[i * sub : (i + 1) * sub].to(dev, copy=True),
                  cnt[i * sub : (i + 1) * sub].to(dev, copy=True))
                 for i, dev in enumerate(self.mesh)]
        return DpSparseState(raw=self._fresh_raw(self._raw_cap0()),
                             fill=0, store=store, store_len=Lc,
                             distinct=drows)
