"""Restartable streaming count (`findkmer-torch stream`).

Counterpart of `findkmer_tpu/streaming.py`.  Streaming with periodic
checkpoints (utils/checkpoint.py) and exact resume: on restart the
deterministic batch stream is replayed and the batches a checkpoint
covers are skipped on the host, without touching the device.  Composes
with the disk spill (the checkpoint's manifest records the spill runs of
its prefix) and with several independent hosts (each streams its share of
the batches and checkpoints into its own proc subdir, and writes a
partial spectrum).  A process group with a coordinator is not yet ported
(parallel/multihost.py).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import torch

from findkmer_torch import pipeline
from findkmer_torch import spill
from findkmer_torch.config import Config
from findkmer_torch.parallel import multihost
from findkmer_torch.utils import checkpoint as ckpt_mod
from findkmer_torch.utils.logging import get_logger
from findkmer_torch.utils.prof import PhaseTimers, phases

log = get_logger("findkmer.stream")


def stream_count(
    paths,
    cfg: Config,
    *,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 64,
    stats: Optional[pipeline.StreamStats] = None,
    num_processes: int = 1,
    process_id: int = 0,
    device="cuda",
):
    """Count k-mers across `paths` on `device` with optional
    checkpoint/resume.

    Several hosts: with num_processes > 1 this host deterministically
    takes batches process_id, process_id + P, ... of the global batch
    sequence (parallel/multihost.py) and returns its PARTIAL spectrum;
    the partials sum to the whole (counting is associative).  Checkpoint
    indices are local to this host's subsequence, so resume composes with
    the sharding.

    Returns the finalized (possibly partial) spectrum."""
    counter, state = _stream_state(
        paths, cfg, _resolve(device), checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, stats=stats,
        num_processes=num_processes, process_id=process_id,
    )
    return counter.finalize(state)


def _resolve(device):
    from findkmer_torch.api import _device

    return _device(device)


def _stream_state(
    paths,
    cfg: Config,
    device,
    *,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 64,
    stats: Optional[pipeline.StreamStats] = None,
    num_processes: int = 1,
    process_id: int = 0,
    row_sort: str = "auto",
    dense_kernel: str = "fused",
    timers=None,
):
    """The streaming loop up to (but not including) finalize: returns
    (counter, state), so that callers choose between finalize() and the
    streamed finalize_chunks() write path.  `timers`
    (utils.prof.PhaseTimers) gets the phases of `pipeline.run_count` and
    each checkpoint's (`_save`)."""
    from findkmer_torch.models.counter import make_counter

    if num_processes > 1:
        # per-process subdirs: checkpoint indices are local to each
        # host's batch subsequence and spill runs carry a per-stream
        # identity token, so hosts sharing a filesystem must never
        # share either directory.  Both remaps live HERE so that the
        # stream_count API gets them too, not only the CLI.
        if checkpoint_dir is not None:
            checkpoint_dir = os.path.join(
                checkpoint_dir, f"proc{process_id:03d}"
            )
        if cfg.spill_dir:
            cfg = cfg.replace(
                spill_dir=os.path.join(cfg.spill_dir,
                                       f"proc{process_id:03d}")
            )
    pipeline.host_encoder(cfg.use_native_encode)  # build the C encoder first
    counter = make_counter(cfg, device, row_sort=row_sort,
                           dense_kernel=dense_kernel)
    start_batch = 0
    state = None
    if checkpoint_dir is not None:
        loaded = ckpt_mod.load_latest(checkpoint_dir, cfg)
        if loaded is not None:
            start_batch, table, _, extra = loaded
            # batch_index indexes THIS host's round-robin subsequence
            # (i % num_processes == process_id): resuming under another
            # host count or id would silently skip the wrong batches.
            # Validate like any other semantic config field.
            for field, cur in (("num_processes", num_processes),
                               ("process_id", process_id)):
                saved = extra.get(field)
                if saved is not None and saved != cur:
                    raise ValueError(
                        f"checkpoint was written with {field}={saved}; "
                        f"resuming with {field}={cur} would replay the "
                        "wrong batch subsequence — relaunch with the "
                        "original topology"
                    )
            # restore_state copies: no later in-place step writes into
            # the loaded arrays
            state = counter.restore_state(table)
            # spill composition: adopt the runs that the checkpoint's
            # prefix wrote; delete any spilled after it (their batches
            # replay).  The identity token stops a resume from adopting
            # or deleting a DIFFERENT count's runs left in the same dir.
            counter.adopt_spill_runs(
                int(extra.get("spill_runs", 0)),
                token=extra.get("spill_token"),
            )
            log.info("resuming from checkpoint at batch %d", start_batch)
    if state is None:
        state = counter.init_state()

    def batches():
        def all_batches():
            for path in paths:
                # stats recount the FULL replayed stream (skipped batches
                # really are re-encoded on the host during the skip), so
                # a resumed run's totals equal a run's from scratch
                yield from pipeline.batches_from_file(
                    path, cfg, stats=stats
                )

        if num_processes > 1:
            yield from multihost.shard_batches_round_robin(
                all_batches(), num_processes, process_id
            )
        else:
            yield from all_batches()

    it = batches()
    # exact resume: skip the batches that the checkpoint covers, on the
    # host iterator, before the stager wraps it (a skipped batch is never
    # staged).  A replay stream SHORTER than the checkpoint's batch index
    # means the input changed since the checkpoint: an error beats
    # emitting the stale table as a "complete" result.
    for skipped in range(start_batch):
        try:
            next(it)
        except StopIteration:
            raise ValueError(
                f"checkpoint was taken at batch {start_batch} but "
                f"the replayed input ends after {skipped} batches; "
                "the input changed since the checkpoint — restore "
                "the original inputs or restart the count"
            ) from None

    def save(state):
        return _save(counter, checkpoint_dir, cfg, batch_index, state,
                     stats, num_processes=num_processes,
                     process_id=process_id, timers=timers)

    ph = phases(timers)
    batch_index = saved_at = start_batch
    staged = pipeline.prefetch_to_device(it, cfg.prefetch, counter.device)
    try:
        while True:
            with ph("host_batches"):
                rows = next(staged, None)
            if rows is None:
                break
            with ph("dispatch"):
                state = counter.step(state, rows)
            batch_index += 1
            if (
                checkpoint_dir is not None
                and checkpoint_every > 0
                and batch_index % checkpoint_every == 0
            ):
                state = save(state)
                saved_at = batch_index
    finally:
        staged.close()  # stops the producer thread if a step or save raised
    # the final checkpoint, unless the last batch's own has just been
    # written (the same table under the same name)
    if checkpoint_dir is not None and batch_index > saved_at:
        state = save(state)
    return counter, state


def _save(counter, checkpoint_dir, cfg, batch_index, state, stats,
          num_processes: int = 1, process_id: int = 0, timers=None):
    with phases(timers)("checkpoint/compact"):
        state, table = counter.table_state(state)  # compacts buffered codes
        if timers is not None and counter.device.type == "cuda":
            # the squeeze is still in flight: drain it, or its time
            # would be read as the copy's
            torch.cuda.synchronize(counter.device)
    # the barrier is checkpoint.save's own: it copies every plane to the
    # host on the compute stream before it returns, so the copy is
    # complete before the next step is launched (the dense table is the
    # live state, added into in place)
    #
    # the host topology is checkpoint semantics too: batch_index indexes
    # this host's round-robin subsequence (validated on resume)
    extra = {"num_processes": num_processes, "process_id": process_id}
    # spill runs written so far (table_state's compaction may have just
    # spilled one) belong to this checkpoint's prefix: record them, so
    # that resume adopts exactly these and deletes later ones
    if cfg.spill_dir:
        extra.update(
            spill_runs=int(counter._spill_n),
            spill_token=spill.read_token(cfg.spill_dir),
        )
    ckpt_mod.save(
        checkpoint_dir,
        cfg,
        batch_index,
        table,
        stats.as_dict() if stats is not None else {},
        extra=extra,
        timers=timers,
    )
    log.info("checkpoint @ batch %d", batch_index)
    return state


def run_stream(args, row_sort: str = "auto",
               dense_kernel: str = "fused") -> int:
    """CLI adapter for `findkmer-torch stream` (cli.py)."""
    from findkmer_torch import output as output_mod
    from findkmer_torch.cli import (
        _cfg_from_args,
        _open_out,
        _refuse_unported,
        _use_streamed_finalize,
        _warn_numpy_encoder,
        emit_streamed_spectrum,
    )
    from findkmer_torch.device import resolve_device

    cfg = _cfg_from_args(args)
    _refuse_unported(args, cfg)
    num_processes, process_id = multihost.initialize(
        args.coordinator, args.num_processes, args.process_id
    )
    device = resolve_device(args.device)
    encoder = _warn_numpy_encoder(cfg)
    stats = pipeline.StreamStats()
    timers = PhaseTimers() if args.stats == "json" else None
    # per-process spill/checkpoint subdirs are applied inside
    # _stream_state (shared with the stream_count API)
    t0 = time.time()
    counter, state = _stream_state(
        args.input,
        cfg,
        device,
        checkpoint_dir=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        stats=stats,
        num_processes=num_processes,
        process_id=process_id,
        row_sort=row_sort,
        dense_kernel=dense_kernel,
        timers=timers,
    )
    ph = phases(timers)
    if _use_streamed_finalize(counter):
        # sparse: format and write each finalize chunk while the next
        # one's device-to-host copy is in flight
        emit_streamed_spectrum(counter, state, cfg, args.output,
                               timers=timers)
    else:
        with ph("finalize"):
            spectrum = counter.finalize(state, timers=timers)
        f, close = _open_out(args.output)
        try:
            with ph("write"):
                output_mod.write_spectrum(f, spectrum, cfg)
        finally:
            if close:
                f.close()
    wall = time.time() - t0
    if args.stats == "json":
        d = stats.as_dict()
        d["wall_s"] = wall
        d["device"] = (
            torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu"
        )
        d["host_encoder"] = encoder
        d["phases"] = timers.as_dict()
        print(json.dumps(d), file=sys.stderr)
    return 0
