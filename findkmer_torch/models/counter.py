"""KmerCounter of the port: the dense table and the sparse row store.

Counterpart of `findkmer_tpu/models/counter.py` with the same counter
interface: `make_counter` -> `init_state` / `step` / `flush` / `finalize`
/ `finalize_chunks` / `put_batch` / `table_state` / `restore_state`, so
the host layer drives either engine alike.  PyTorch runs eagerly, so
there is no jit; buffers the JAX steps donate are updated in place.

Dense (k <= Config.direct_k_max, or table_mode="direct"): one step per
batch, `rows_from_batch` -> `window_codes` -> a histogram added into the
table.  The histogram is picked from `Config.hist` as in the JAX package:
  * auto:    the CUDA kernel K1 (`ops/cuda/histogram_kernel.py`) when the
             counter's device is CUDA and k <= 10, else scatter.
  * pallas:  the kernel's wrapper (the TPU package's name for its hand
             kernel); on a CPU device the wrapper runs its plain twin.
  * scatter / sort / onehot: the plain ops of `ops/histogram.py`.

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
    before.
Codes are one integer (int32 for k <= 15, int64 above; `ops/window.py`).
Not yet ported: the disk spill (--spill), the legacy heap-merge finalize
(FINDKMER_ORDERED_FINALIZE=0) and multi-device counting.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from findkmer_tpu.config import Config
from findkmer_torch import table as table_mod
from findkmer_torch.models import rowstore
from findkmer_torch.models.rowstore import RowStoreMixin
from findkmer_torch.ops import compaction
from findkmer_torch.ops import histogram as hist_ops
from findkmer_torch.ops import sparse as sparse_ops
from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda.histogram_kernel import MAX_K, add_counts_cuda

# Minimum row count of the store (the JAX package's STORE_ROWS) and the
# column ladder floor: the same geometry as the reference store.
STORE_ROWS = 64
COL_FLOOR = 64
ROW_SORTS = ("auto", "kernel", "plain")
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


def make_counter(cfg: Config, device: torch.device, row_sort: str = "auto"):
    """The single-device counter for cfg on `device`."""
    from findkmer_tpu.utils.shmalloc import ensure_shared_alloc

    ensure_shared_alloc()  # before this run's big host buffers exist
    if cfg.devices != 1:
        raise NotImplementedError(
            f"--devices {cfg.devices}: multi-device counting is not yet "
            "ported to findkmer_torch (ROADMAP.md Queue 1 item 13)"
        )
    return KmerCounter(cfg, device, row_sort=row_sort)


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
                 row_sort: str = "auto"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mode = cfg.resolved_table_mode
        if row_sort not in ROW_SORTS:
            raise ValueError(
                f"row_sort must be one of {ROW_SORTS}, got {row_sort!r}"
            )
        if cfg.spill_dir:
            if self.mode != "sparse":
                raise ValueError(
                    "--spill requires a sparse table "
                    f"(k={cfg.k} resolves to a direct table)"
                )
            raise NotImplementedError(
                "--spill is not yet ported to findkmer_torch (ROADMAP.md "
                "Queue 1 item 8)"
            )
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
        return SparseState(raw=self._fresh(self._raw_cap0()))

    def step(self, state, batch):
        """One batch update.

        batch: (B, R) uint8 code rows, or a (packed, validbits) pair in
        the 2-bit H2D format (Config.packed_h2d; unpacked on device).
        The dense table and the raw buffer are updated in place."""
        cfg = self.cfg
        if self.mode == "direct":
            if self._method == "pallas":
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
                # count may decide the capacity error
                state, d = self._dedup_state(state)
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

    # ------------------------------------------------------------------
    def finalize(self, state, timers=None):
        """The spectrum on the host: dense -> np counts (4^k,); sparse ->
        (codes uint64, counts int64), sorted and distinct."""
        if self.mode == "direct":
            return state.to_host()
        parts = [(c.copy(), n.copy())
                 for c, n in self.finalize_chunks(state, timers=timers)]
        if not parts:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        return (np.concatenate([c for c, _ in parts]),
                np.concatenate([n for _, n in parts]))

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
        ph = timers.phase if timers is not None else (
            lambda name: contextlib.nullcontext()
        )
        with ph("finalize/compact"):
            state = self.compact(state)
            state, _ = self._ensure_capacity(state)
        with ph("finalize/global_sort"):
            codes, counts = sparse_ops.global_compact(*state.store)
        yield from _pull_chunks(codes, counts, ph)

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
