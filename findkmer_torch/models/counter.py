"""KmerCounter of the port: the dense table and the sparse row store.

Counterpart of `findkmer_tpu/models/counter.py` with the same counter
interface: `make_counter` -> `init_state` / `step` / `flush` / `finalize`
/ `finalize_chunks` / `put_batch` / `table_state` / `restore_state`, so
the host layer drives either engine alike.  PyTorch runs eagerly, so
there is no jit; buffers the JAX steps donate are updated in place.

Dense (k <= Config.direct_k_max, or table_mode="direct"): one step per
batch adds the histogram of the batch's valid windows into the table.
The histogram is picked from `Config.hist` as in the JAX package:
  * auto:    the hand kernels ("pallas" below) when the counter's device
             is CUDA and k <= 10, else scatter.
  * pallas:  the kernels' wrappers (the TPU package's name for its hand
             kernels); on a CPU device each wrapper runs its plain version.
             `dense_kernel` picks which:
               "fused" (the default): K2 (`ops/cuda/window_histogram_
               kernel.py`), window extraction and binning in one kernel,
               straight from the 2-bit wire (or from uint8 rows);
               "two_stage": `rows_from_batch` -> `window_codes` (plain
               torch) -> K1 (`ops/cuda/histogram_kernel.py`), kept as the
               cross-check.
  * scatter / sort / onehot: `rows_from_batch` -> `window_codes` -> the
             plain ops of `ops/histogram.py`.

Sparse (k above the dense limit, or table_mode="sparse"): the JAX
package's log-structured store.
  * step: extract the batch's window codes straight from the packed wire
    (`window_codes_packed`) into the raw buffer at the fill offset: no
    sort, no host sync.
  * compaction (the raw buffer would pass sparse_compact_entries, or a
    finalize / checkpoint): one row-wise sort of [store + raw] and a
    run-length encoding into a (G, cols) store of sorted rows, where
    duplicates keep their code with count 0; holes are squeezed out when
    they pass half the row.  The row sort is K3 (`row_sort`: "auto" is
    the kernel on CUDA and the plain version on the CPU; "kernel" and
    "plain" force one).
  * finalize: one flat sort of the live entries, run totals, and the
    distinct sorted spectrum pulled to the host in chunks through pinned
    buffers, each chunk's copy in flight while the host formats the one
    before.  FINDKMER_ORDERED_FINALIZE=0 takes the heap-merge finalize
    instead: the squeezed row store is pulled as it is and its G rows are
    merged on the host in C (`ops/sparse.store_to_host_2d`); same
    spectrum, an A/B route.
  * disk spill (Config.spill_dir; `spill.py`): a compaction that finds
    the exact distinct count past sparse_capacity writes the store to a
    sorted run file and restarts it from the raw buffer alone; finalize
    is then a streaming k-way merge of the runs and the residual store,
    and deletes the runs it consumed.
Codes are one integer (int32 for k <= 15, int64 above; `ops/window.py`).
Not yet ported: multi-device counting.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from findkmer_torch import spill
from findkmer_torch import table as table_mod
from findkmer_torch.config import Config
from findkmer_torch.models import rowstore
from findkmer_torch.models.rowstore import RowStoreMixin
from findkmer_torch.ops import compaction
from findkmer_torch.ops import histogram as hist_ops
from findkmer_torch.ops import sparse as sparse_ops
from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda.histogram_kernel import MAX_K, add_counts_cuda
from findkmer_torch.ops.cuda.window_histogram_kernel import (
    add_window_counts_cuda,
)
from findkmer_torch.utils.prof import phases

# Minimum row count of the store (the JAX package's STORE_ROWS) and the
# column ladder floor: the same geometry as the reference store.
STORE_ROWS = 64
COL_FLOOR = 64
ROW_SORTS = ("auto", "kernel", "plain")
DENSE_KERNELS = ("fused", "two_stage")
# finalize chunk size: entries pulled to the host per pinned copy
FINALIZE_CHUNK = 1 << 22


def _dense_step(
    table: torch.Tensor,
    batch,
    k: int,
    canonical: bool,
    table_size: int,
    method: str,
    R: int,
) -> torch.Tensor:
    rows = window_ops.rows_from_batch(batch, R)
    codes, valid = window_ops.window_codes(rows, k, canonical)
    return hist_ops.dense_counts(codes, valid, table, table_size, method)


def _kernel_dense_step(
    table: torch.Tensor, batch, k: int, canonical: bool, R: int
) -> torch.Tensor:
    rows = window_ops.rows_from_batch(batch, R)
    return add_counts_cuda(rows, table, k, canonical)


def batch_slots(batch, k: int, R: int) -> int:
    """Raw code slots a batch emits, from its shapes alone."""
    if isinstance(batch, (tuple, list)):
        B, NB = batch[0].shape
        return window_ops.packed_slots(B, NB, k, R)
    B, Rb = batch.shape
    return B * max(Rb - k + 1, 0)


def ingest(out: torch.Tensor, batch, k: int, canonical: bool, R: int):
    """Write one batch's sentinel-masked window codes into `out` (a slice
    of the raw buffer, exactly `batch_slots` long)."""
    if isinstance(batch, (tuple, list)):
        window_ops.window_codes_packed(batch[0], batch[1], k, canonical,
                                       R=R, out=out)
        return
    codes, valid = window_ops.window_codes(batch, k, canonical)
    out.copy_(torch.where(valid, codes,
                          window_ops.sentinel(codes.dtype)).reshape(-1))


def make_counter(cfg: Config, device: torch.device, row_sort: str = "auto",
                 dense_kernel: str = "fused"):
    """The single-device counter for cfg on `device`."""
    from findkmer_torch.utils.shmalloc import ensure_shared_alloc

    ensure_shared_alloc()  # before this run's big host buffers exist
    if cfg.devices != 1:
        raise NotImplementedError(
            f"--devices {cfg.devices}: multi-device counting is not yet "
            "ported to findkmer_torch (ROADMAP.md Queue 1 item 13)"
        )
    return KmerCounter(cfg, device, row_sort=row_sort,
                       dense_kernel=dense_kernel)


@dataclass
class SparseState:
    """Log-structured sparse counting state.

    raw:   (cap,) code buffer, sentinel past `fill`; fill is tracked on
           the host from batch shapes, so a step never syncs.
    store: (codes, counts) (G, store_len) row store of the last
           compaction (None before the first): each row sorted and
           run-length encoded, holes with count 0.
    distinct: per-row distinct vector of the last compaction (a device
           tensor, read on the host only at the next compaction, when it
           has long been computed)."""

    raw: torch.Tensor
    fill: int = 0
    store: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    store_len: int = 0
    distinct: object = 0


class KmerCounter(RowStoreMixin):
    """Single-device k-mer counter: dense table or sparse row store."""

    def __init__(self, cfg: Config, device: torch.device,
                 row_sort: str = "auto", dense_kernel: str = "fused"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mode = cfg.resolved_table_mode
        if row_sort not in ROW_SORTS:
            raise ValueError(
                f"row_sort must be one of {ROW_SORTS}, got {row_sort!r}"
            )
        if dense_kernel not in DENSE_KERNELS:
            raise ValueError(
                f"dense_kernel must be one of {DENSE_KERNELS}, got "
                f"{dense_kernel!r}"
            )
        self.dense_kernel = dense_kernel
        self._spill_n = 0  # spill runs written (or adopted) so far
        if cfg.spill_dir:
            if self.mode != "sparse":
                raise ValueError(
                    "--spill requires a sparse table "
                    f"(k={cfg.k} resolves to a direct table)"
                )
            # stale runs are refused in init_state (a fresh count) or
            # adopt_spill_runs (a checkpoint resume), not here: the
            # constructor cannot know which follows
            os.makedirs(cfg.spill_dir, exist_ok=True)
        if self.mode == "direct":
            self._method = self._dense_method(cfg)
            return
        self._plain_sort = row_sort == "plain" or (
            row_sort == "auto" and self.device.type != "cuda"
        )
        self._code_dtype = window_ops.code_dtype(cfg.k)
        # store-row geometry is fixed per counter: every raw cap this
        # counter will reshape is a ladder value >= the initial cap, all
        # divisible by this power of two
        self._rows = compaction.row_geometry(self._raw_cap0(), g0=STORE_ROWS)

    def _dense_method(self, cfg: Config) -> str:
        m = cfg.hist
        if m == "pallas":
            if cfg.k > MAX_K:
                raise ValueError(
                    f"the histogram kernel needs k <= {MAX_K} (got k={cfg.k})"
                )
        elif m == "auto":
            m = (
                "pallas"
                if self.device.type == "cuda" and cfg.k <= MAX_K
                else "scatter"
            )
        return m

    def _dedup_geometry(self):
        """One device group of G rows (models/rowstore.py contract)."""
        return 1, self._rows, COL_FLOOR

    # ------------------------------------------------------------------
    def put_batch(self, batch):
        """Host batch (array or (packed, validbits) pair) -> tensors on
        this counter's device.  The pipeline's prefetch stages batches
        through pinned buffers instead; this is the plain path."""
        if isinstance(batch, (tuple, list)):
            return tuple(self.put_batch(a) for a in batch)
        return torch.from_numpy(batch).to(self.device)

    def _raw_cap0(self) -> int:
        """Initial raw-buffer capacity, the JAX engine's rule: the
        expected-size hint when the caller knows it, else two batches'
        worth; an input smaller than one batch gets about twice its size.
        Underestimates heal: the step grows the buffer by the ladder."""
        per_batch = self.cfg.batch_rows * self.cfg.window_len
        exp = self.cfg.sparse_expected_entries
        if exp:
            want = max(exp, 2 * per_batch)
            if exp < per_batch:
                want = min(want, 2 * exp + 4096)
        else:
            want = 2 * per_batch
        return sparse_ops.ladder(min(want, self._target_cap()), floor=4096)

    def _target_cap(self) -> int:
        return sparse_ops.ladder(
            max(self.cfg.sparse_compact_entries,
                self.cfg.batch_rows * self.cfg.window_len),
            floor=4096,
        )

    def _fresh(self, cap: int) -> torch.Tensor:
        return rowstore.fresh_raw(cap, self._code_dtype, self.device)

    def init_state(self):
        if self.mode == "direct":
            return table_mod.make_table(self.cfg, self.device)
        if self._spill_n:
            raise RuntimeError(
                "this counter already spilled runs for a previous "
                "state; use a fresh counter (and an empty spill dir) "
                "per count"
            )
        if self.cfg.spill_dir:
            spill.init_dir(self.cfg.spill_dir)  # refuses stale runs
        return SparseState(raw=self._fresh(self._raw_cap0()))

    def step(self, state, batch):
        """One batch update.

        batch: (B, R) uint8 code rows, or a (packed, validbits) pair in
        the 2-bit H2D format (Config.packed_h2d; unpacked on device).
        The dense table and the raw buffer are updated in place."""
        cfg = self.cfg
        if self.mode == "direct":
            if self._method == "pallas" and self.dense_kernel == "fused":
                add_window_counts_cuda(batch, state.counts, cfg.k,
                                       cfg.canonical, cfg.row_len)
            elif self._method == "pallas":
                _kernel_dense_step(
                    state.counts, batch, cfg.k, cfg.canonical, cfg.row_len
                )
            else:
                _dense_step(
                    state.counts, batch, cfg.k, cfg.canonical,
                    cfg.table_size, self._method, cfg.row_len,
                )
            return state

        n = batch_slots(batch, cfg.k, cfg.row_len)
        cap = state.raw.shape[0]
        if state.fill + n > cap:
            if state.fill + n > self._target_cap():
                state = self.compact(state)
                cap = state.raw.shape[0]
            raw = state.raw
            while state.fill + n > cap:
                cap = sparse_ops.ladder(max(state.fill + n, 2 * cap),
                                        floor=4096)
                raw = rowstore.grow_raw(raw, cap)
            state = dataclasses.replace(state, raw=raw)
        fill = state.fill
        ingest(state.raw[fill : fill + n], batch, cfg.k, cfg.canonical,
               cfg.row_len)
        return dataclasses.replace(state, fill=fill + n)

    # ------------------------------------------------------------------
    def compact(self, state):
        """Fold the raw buffer into the sorted row store (one row sort +
        run-length encoding).  No-op for dense, or when nothing is
        buffered since the last compaction."""
        if self.mode == "direct":
            return state
        if state.fill == 0 and state.store is not None:
            return state
        cfg = self.cfg
        G = self._rows
        cap = state.raw.shape[0]
        cdt = table_mod.count_dtype(cfg)
        if state.store is None:
            store, drows = compaction.compact_raw_rows(
                state.raw, G, cap // G, cdt, self._plain_sort)
            Lc = cap // G
        else:
            # the previous compaction's per-row counts: long computed
            d = rowstore.host_distinct(state.distinct)
            if self._distinct_total(d) > cfg.sparse_capacity:
                # the sum counts store ENTRIES; only the exact distinct
                # count may decide a spill or the capacity error
                state, d = self._dedup_state(state)
            if (cfg.spill_dir
                    and self._distinct_total(d) > cfg.sparse_capacity):
                # disk spill: the sorted store becomes a run file, and
                # the store restarts from the raw buffer alone
                self._spill_store(state.store)
                state = dataclasses.replace(state, store=None)
                store, drows = compaction.compact_raw_rows(
                    state.raw, G, cap // G, cdt, self._plain_sort)
                return SparseState(raw=self._fresh(cap), fill=0,
                                   store=store, store_len=cap // G,
                                   distinct=drows)
            self._check_capacity(self._distinct_total(d))
            store, store_cols = state.store, state.store_len
            Ldc = sparse_ops.ladder(int(d.max()), floor=COL_FLOOR)
            if store_cols > 2 * Ldc:
                # hole fraction > 1/2: squeeze rows before re-sorting
                store = compaction.squeeze_slice(store, Ldc,
                                                 self._plain_sort)
                store_cols = Ldc
            Lc = sparse_ops.ladder(store_cols + cap // G, floor=COL_FLOOR)
            store, drows = compaction.compact_counted_rows(
                store, state.raw, G, Lc, self._plain_sort)
        return SparseState(raw=self._fresh(cap), fill=0, store=store,
                           store_len=Lc, distinct=drows)

    def flush(self, state):
        """Force a compaction (checkpoint / bench)."""
        return self.compact(state)

    def _spill_store(self, store):
        """Pull the compacted store as one globally sorted distinct run
        and persist it as the next spill run."""
        codes, counts = _pull_owned(*sparse_ops.global_compact(*store))
        spill.write_run(self.cfg.spill_dir, self._spill_n, codes, counts)
        self._spill_n += 1

    def _merged_spill_chunks(self, state, ph):
        """Streaming k-way merge of the spill runs with the residual
        store (spill.iter_merged): sorted distinct host chunks.  The run
        files are deleted once the merge has consumed them, so a SECOND
        finalize of a spilled state is an error, never a spectrum without
        its runs."""
        runs = spill.load_runs(self.cfg.spill_dir)
        if not runs:
            raise RuntimeError(
                "spill runs missing (already consumed by a previous "
                "finalize, or deleted); rerun the count"
            )
        with ph("finalize/residual_pull"):
            # owned arrays: the merge reads the residual run block by
            # block, long after a pinned chunk buffer would be reused
            runs.append(_pull_owned(
                *sparse_ops.global_compact(*state.store)))
        merged = spill.iter_merged(runs)
        while True:
            with ph("finalize/merge"):
                block = next(merged, None)
            if block is None:
                break
            yield block
        spill.remove_runs(self.cfg.spill_dir)  # consumed: free the disk

    def _store_to_host(self, store, ph):
        """Row store -> host (codes uint64 sorted distinct, counts int64)
        by the heap merge: pull the planes as they are, strip each row's
        holes and merge the G rows in one C pass."""
        with ph("finalize/d2h"):
            codes, cnt = (a.cpu().numpy() for a in store)
        with ph("finalize/merge"):
            return sparse_ops.store_to_host_2d(codes, cnt)

    # ------------------------------------------------------------------
    def finalize(self, state, timers=None):
        """The spectrum on the host: dense -> np counts (4^k,); sparse ->
        (codes uint64, counts int64), sorted and distinct.

        The sparse default gathers `finalize_chunks` (the ordered
        finalize, or the spill merge).  FINDKMER_ORDERED_FINALIZE=0 takes
        the heap-merge finalize of an unspilled store instead."""
        if self.mode == "direct":
            return state.to_host()
        ph = phases(timers)
        # compact FIRST: the finalize's own compaction may write the first
        # spill run, and only then is `_spill_n` the route's truth
        state, d = self._compacted(state, ph)
        if (not self._spill_n
                and os.environ.get("FINDKMER_ORDERED_FINALIZE", "1") != "1"):
            return self._finalize_heap_merge(state, d, ph)
        parts = [(c.copy(), n.copy())
                 for c, n in self._sorted_chunks(state, ph)]
        if not parts:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        return (np.concatenate([c for c, _ in parts]),
                np.concatenate([n for _, n in parts]))

    def _compacted(self, state, ph):
        """(state, per-row distinct counts) with the raw buffer folded in
        and the capacity checked: the front of every finalize."""
        with ph("finalize/compact"):
            state = self.compact(state)
            return self._ensure_capacity(state)

    def _finalize_heap_merge(self, state, d, ph):
        """The heap-merge finalize of a compacted, unspilled state."""
        with ph("finalize/squeeze"):
            # holes squeezed out and rows cut to the live ladder before
            # the pull: one more row sort, fewer bytes to pull and strip.
            # The squeeze sorts the counts in place, so it gets a copy:
            # finalize leaves the state as it was.
            store = state.store
            Ldc = sparse_ops.ladder(int(d.max()), floor=COL_FLOOR)
            if state.store_len > Ldc:
                store = compaction.squeeze_slice(
                    (store[0], store[1].clone()), Ldc, self._plain_sort)
        return self._store_to_host(store, ph)

    def _sorted_chunks(self, state, ph):
        """Chunks of a compacted state: the spill merge when runs were
        written, else the ordered finalize's chunked pull."""
        if self._spill_n:
            yield from self._merged_spill_chunks(state, ph)
            return
        with ph("finalize/global_sort"):
            codes, counts = sparse_ops.global_compact(*state.store)
        yield from _pull_chunks(codes, counts, ph)

    def finalize_chunks(self, state, timers=None):
        """The sparse spectrum as host chunks (codes uint64, counts int64)
        in globally sorted distinct order; they concatenate to
        finalize(state).

        A chunk's arrays may live in a reused pinned buffer: they are
        valid until the next chunk is requested (copy them to keep them).
        On a CUDA device every chunk's device-to-host copy is issued one
        chunk ahead, so it runs while the caller formats the chunk
        before."""
        if self.mode == "direct":
            raise ValueError("finalize_chunks is for sparse tables")
        ph = phases(timers)
        state, _ = self._compacted(state, ph)
        yield from self._sorted_chunks(state, ph)

    # ------------------------------------------------------------------
    def table_state(self, state):
        """(state, checkpointable table), compacting buffered codes
        first: the dense state is its own table; a sparse store is
        squeezed to its live ladder and wrapped as a SparseTable."""
        if self.mode == "direct":
            return state, state
        state = self.compact(state)
        state, d = self._ensure_capacity(state)
        return self._store_table(state, d)

    def restore_state(self, table):
        """Step state from a table.

        Dense: the port's own, or any object with `counts` (numpy, a JAX
        array or a tensor) and `k`, such as a JAX DenseTable; host counts
        are copied onto this counter's device.  Sparse: the port's
        SparseTable, or one with host planes (hi, lo, cnt) such as the
        JAX counter's `table_state`; the entries merge to one sorted
        distinct run, re-dealt as G contiguous rows."""
        if table.k != self.cfg.k:
            raise ValueError(
                f"table is for k={table.k}, counter for k={self.cfg.k}"
            )
        if self.mode == "direct":
            if isinstance(table.counts, torch.Tensor):
                return table_mod.DenseTable(
                    counts=table.counts.to(self.device), k=table.k
                )
            return table_mod.DenseTable.from_host(
                np.asarray(table.counts), table.k, self.device
            )
        store, Lc, drows = self._restore_planes(table)
        return SparseState(raw=self._fresh(self._raw_cap0()), store=store,
                           store_len=Lc, distinct=drows)


def _pull_owned(codes: torch.Tensor, counts: torch.Tensor):
    """A device spectrum on the host as arrays of its own (codes uint64,
    counts int64), gathered from `_pull_chunks`."""
    out_c = np.empty(codes.shape[0], np.uint64)
    out_n = np.empty(codes.shape[0], np.int64)
    at = 0
    for c, n in _pull_chunks(codes, counts, phases(None)):
        out_c[at : at + c.size] = c
        out_n[at : at + c.size] = n
        at += c.size
    return out_c, out_n


def _chunk_spans(n: int):
    """[a, b) spans of the finalize pull.  FINDKMER_FINALIZE_CHUNKS forces
    the chunk count (<= 0 or unset: FINALIZE_CHUNK entries a chunk)."""
    forced = int(os.environ.get("FINDKMER_FINALIZE_CHUNKS", "0"))
    step = -(-n // forced) if forced > 0 else FINALIZE_CHUNK
    step = max(step, 1)
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _pull_chunks(codes: torch.Tensor, counts: torch.Tensor, ph):
    """Yield host (codes uint64, counts int64) chunks of a device
    spectrum.  CUDA: two pinned buffer pairs alternate; chunk i+1's copy
    is issued before chunk i is handed to the caller."""
    spans = _chunk_spans(codes.shape[0])
    if codes.device.type != "cuda":
        for a, b in spans:
            with ph("finalize/d2h"):
                c = codes[a:b].numpy().astype(np.uint64)
                n = counts[a:b].numpy().astype(np.int64)
            yield c, n
        return
    if not spans:
        return
    width = spans[0][1] - spans[0][0]
    bufs = [
        (torch.empty(width, dtype=torch.int64, pin_memory=True),
         torch.empty(width, dtype=torch.int64, pin_memory=True),
         torch.cuda.Event())
        for _ in range(min(2, len(spans)))
    ]

    def issue(i):
        a, b = spans[i]
        hc, hn, ev = bufs[i % len(bufs)]
        hc[: b - a].copy_(codes[a:b], non_blocking=True)
        hn[: b - a].copy_(counts[a:b], non_blocking=True)
        ev.record()

    with ph("finalize/d2h"):
        issue(0)
    for i, (a, b) in enumerate(spans):
        with ph("finalize/d2h"):
            if i + 1 < len(spans):
                issue(i + 1)
            hc, hn, ev = bufs[i % len(bufs)]
            ev.synchronize()
        yield (hc[: b - a].numpy().view(np.uint64), hn[: b - a].numpy())
