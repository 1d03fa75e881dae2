"""The staged counting steps of `findkmer-torch bench`.

Each times the counter's device step with its batch already on the
device (no host reader, no H2D, no output): `bench_dense_step` the dense
table's step over uint8 code rows (on CUDA the uint8-row entry of the
fused window histogram kernel), `bench_sparse_step` the sparse store's
ingest of the 2-bit wire plus the one compaction that folds it (the row
sort kernel).  Inputs are the reference's draw for draw
(`np.random.default_rng(0)`), so both packages count the same rows.

`_dense_run` and `_sparse_run` do the work and return the counter and its
final state beside the seconds: the tests and `chip_smoke.py` hold that
state to other routes; the public functions return the reference's
`(bases_per_s, seconds)` (and the finalize's seconds with
`time_finalize`).  `bench_end_to_end` counts a FASTA file through the
pipeline.  `driver.py` makes the reference `bench.py`'s five
measurements from these steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from findkmer_torch.config import Config


def setup(device: str = "cuda") -> torch.device:
    """The shared-memory host allocator, then the torch device ('cuda'
    without one raises: no CPU fallback).  The counterpart of the
    reference's `setup_jax`; the CUDA kernels are built by the first
    (warm-up) step, outside the timed window."""
    from findkmer_torch.device import resolve_device
    from findkmer_torch.utils.shmalloc import ensure_shared_alloc

    ensure_shared_alloc()
    return resolve_device(device)


def _sync(t: torch.Tensor) -> int:
    """Hard sync: pull a reduction of `t` to the host, so the clock stops
    only after the device has finished everything queued before it."""
    return int(t.sum())


def dense_rows(batch_rows: int, row_len: int) -> np.ndarray:
    """The dense step's one batch: (batch_rows, row_len) uint8 codes, 1%
    of them 4 (N) so the validity masking runs."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 4, (batch_rows, row_len), dtype=np.uint8)
    rows[rng.random(rows.shape) < 0.01] = 4
    return rows


def sparse_wire(cfg: Config) -> tuple:
    """The sparse step's one batch in the production wire format: 2-bit
    packed codes + validity bits of `cfg.batch_rows` rows."""
    from findkmer_torch.pipeline import _numpy_pack_rows

    rng = np.random.default_rng(0)
    B, L, R = cfg.batch_rows, cfg.chunk_len, cfg.row_len
    work = rng.integers(0, 4, (B - 1) * L + R, dtype=np.uint8)
    return _numpy_pack_rows(work, B, L, R, (R + 7) // 8 * 8)


def _dense_run(device, k=8, batch_rows=256, chunk_len=65536, steps=8,
               hist="auto", canonical=False):
    """One warm-up step, then `steps` timed steps of the staged batch.
    -> (counter, state, seconds of the timed steps)."""
    from findkmer_torch.models.counter import KmerCounter

    cfg = Config(k=k, batch_rows=batch_rows, chunk_len=chunk_len, hist=hist,
                 canonical=canonical)
    counter = KmerCounter(cfg, device)
    rows = counter.put_batch(dense_rows(batch_rows, cfg.row_len))
    state = counter.init_state()
    state = counter.step(state, rows)  # kernel build + warm-up
    _sync(state.counts)
    t0 = time.perf_counter()
    for _ in range(steps):
        state = counter.step(state, rows)
    _sync(state.counts)
    return counter, state, time.perf_counter() - t0


def bench_dense_step(device, k=8, batch_rows=256, chunk_len=65536, steps=8,
                     hist="auto", canonical=False):
    """bases/s of the dense counting step, data staged on the device.
    -> (bases_per_s, seconds)."""
    _, _, dt = _dense_run(device, k=k, batch_rows=batch_rows,
                          chunk_len=chunk_len, steps=steps, hist=hist,
                          canonical=canonical)
    return batch_rows * chunk_len * steps / dt, dt


def _sparse_run(device, k=21, batch_rows=1024, chunk_len=65536, steps=3,
                capacity=1 << 28, canonical=False, time_finalize=False,
                table_mode="auto", row_sort="auto", timers=None):
    """Two runs of `steps` ingests of the staged wire plus one compaction,
    each from a fresh state: the first warms up (and builds the kernels),
    the second is timed.  time_finalize: each run also finalizes its
    compacted store (the warm run too, so no first-call cost lands in the
    timed merge), and the timed run's `counter.finalize` is timed on its
    own by the host clock, into `timers` when given (its sub-phases).
    row_sort picks the store's row sort ("plain": the route the card's
    kernel is held to).  -> (counter, the timed run's compacted state, its
    seconds), and the finalize's seconds last when time_finalize."""
    from findkmer_torch.models.counter import KmerCounter

    cfg = Config(k=k, batch_rows=batch_rows, chunk_len=chunk_len,
                 sparse_capacity=capacity, canonical=canonical,
                 sparse_expected_entries=batch_rows * chunk_len * steps,
                 table_mode=table_mode)
    counter = KmerCounter(cfg, device, row_sort=row_sort)
    wire = counter.put_batch(sparse_wire(cfg))

    def run_once(timed_timers=None):
        t0 = time.perf_counter()
        state = counter.init_state()
        for _ in range(steps):
            state = counter.step(state, wire)
        state = counter.compact(state)
        _sync(state.store[-1])
        dt = time.perf_counter() - t0
        fin_dt = 0.0
        if time_finalize:
            t1 = time.perf_counter()
            counter.finalize(state, timers=timed_timers)
            fin_dt = time.perf_counter() - t1
        return state, dt, fin_dt

    run_once()
    state, dt, fin_dt = run_once(timers)
    if time_finalize:
        return counter, state, dt, fin_dt
    return counter, state, dt


def bench_sparse_step(device, k=21, batch_rows=1024, chunk_len=65536,
                      steps=3, capacity=1 << 28, canonical=False,
                      time_finalize=False, table_mode="auto"):
    """bases/s of the sparse path for big k: the timed window is every
    device step that makes the exact store of `steps` batches (raw-code
    ingest and the final compaction), without the finalize, the copy to
    the host and the output.  -> (bases_per_s, seconds).

    time_finalize: also time `counter.finalize` of the timed run's
    compacted store (the count-table merge: the flat device sort, the
    pinned copies to the host and the host assembly of the spectrum) and
    return (bases_per_s, seconds, finalize_seconds)."""
    out = _sparse_run(device, k=k, batch_rows=batch_rows,
                      chunk_len=chunk_len, steps=steps, capacity=capacity,
                      canonical=canonical, time_finalize=time_finalize,
                      table_mode=table_mode)
    bps = batch_rows * chunk_len * steps / out[2]
    if time_finalize:
        return bps, out[2], out[3]
    return bps, out[2]


def bench_end_to_end(device, path, k=8, hist="auto"):
    """bases/s of counting a real FASTA file host to device end to end
    (`pipeline.count_file` at 64 x 65536 batches).  -> (bases_per_s,
    seconds)."""
    from findkmer_torch import pipeline

    cfg = Config(k=k, hist=hist, batch_rows=64, chunk_len=65536)
    stats = pipeline.StreamStats()
    t0 = time.perf_counter()
    pipeline.count_file(path, cfg, device, stats=stats)
    dt = time.perf_counter() - t0
    return stats.bases / dt, dt
