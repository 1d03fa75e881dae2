"""Checkpoint / resume of streaming counts.

Counterpart of `findkmer_tpu/utils/checkpoint.py`, with the same files:
either package resumes from the other's checkpoints.  The stream persists
(config, batch index, stream stats, count table) every N batches.
Counting is associative and the batch stream is a pure function of
(config, inputs), so resuming from the last checkpoint and skipping the
batches it covers reproduces the same spectrum bit for bit.  No RNG state
exists anywhere in the engine.

Format: one `ckpt_%010d.npz` (np.savez_compressed) per checkpoint and a
JSON pointer `latest.json` (config, batch_index, stats, mode, file,
extra), each written to a temporary name and renamed.  A dense table is
one array, `counts`.  A sparse table is the reference's planes: `lo`
(uint32, the code's low word), `hi` (the high word: uint16 for
16 <= k <= 23, else uint32; all zero for k <= 15), `cnt` and `overflow`;
a slot with count 0 is dead and carries the planes' all-ones sentinels.
The port's store is one code plane, split here on the way out.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from findkmer_torch import table as table_mod
from findkmer_torch.config import Config
from findkmer_torch.utils.prof import phases


def hi_dtype(k: int):
    """dtype of a checkpoint's hi plane (the reference's rule: codes of
    k <= 23 have at most 14 bits above the low word)."""
    return np.uint16 if 16 <= k <= 23 else np.uint32


@dataclass
class SparsePlanes:
    """A loaded sparse checkpoint: host planes as the file holds them.
    `KmerCounter.restore_state` takes it (`rowstore.table_entries`)."""

    hi: np.ndarray
    lo: np.ndarray
    cnt: np.ndarray
    overflow: np.ndarray
    k: int


def split_planes(codes, cnt, k: int) -> dict:
    """The port's (codes, counts) tensors -> the file's host arrays.  Slots
    are told dead BY COUNT, never by code: a hole keeps its code, and a
    real k >= 16 code can have an all-ones low word.

    The split runs where the tensors live, so a store on the card crosses
    to the host as the file's 10 or 12 bytes a slot.  An int64 code is
    read as its two little-endian 32-bit words; an all-ones word is -1
    there and the unsigned sentinel in the file's dtype."""
    dead = cnt == 0
    if k > 15:
        words = codes.contiguous().view(torch.int32)
        lo, hi = words[..., 0::2], words[..., 1::2]
        hdt = hi_dtype(k)
        hi = hi.masked_fill(dead, -1)
        if hdt == np.uint16:
            hi = hi.to(torch.int16)
        hi = hi.cpu().numpy().view(hdt)
    else:
        lo = codes.to(torch.int32)
        hi = torch.zeros_like(lo).masked_fill_(dead, -1)
        hi = hi.cpu().numpy().view(np.uint32)
    lo = lo.masked_fill(dead, -1).cpu().numpy().view(np.uint32)
    return {"hi": hi, "lo": lo, "cnt": cnt.cpu().numpy(),
            "overflow": np.zeros((), bool)}


def save(
    ckpt_dir, cfg: Config, batch_index: int, state, stats_dict: dict,
    extra: Optional[dict] = None, timers=None,
) -> Path:
    """Write the table `state` (a DenseTable or SparseTable of the port)
    as the checkpoint of `batch_index`.

    The table's tensors are copied to the host here, with `Tensor.cpu()`
    on the compute stream: the copy is ordered after every step launched
    so far and the call returns only when it is complete.  The dense step
    adds into its table in place, so no later step can reach the bytes
    that are written.

    extra: small JSON-able side state recorded in the manifest, e.g.
    {"spill_runs": N}, the number of disk-spill run files that belong to
    this checkpoint's prefix (see streaming.py).

    timers (utils.prof.PhaseTimers): "checkpoint/d2h" is the split and the
    copy to the host, "checkpoint/zlib" the compressed write."""
    ph = phases(timers)
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    with ph("checkpoint/d2h"):
        if isinstance(state, table_mod.DenseTable):
            arrays = {"counts": state.counts.cpu().numpy()}
            mode = "direct"
        else:
            arrays = split_planes(state.codes, state.counts, cfg.k)
            mode = "sparse"

    path = d / f"ckpt_{batch_index:010d}.npz"
    tmp_fd, tmp_name = tempfile.mkstemp(dir=str(d), suffix=".tmp")
    try:
        with ph("checkpoint/zlib"), os.fdopen(tmp_fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp_name, path)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise

    meta = {
        "config": json.loads(cfg.to_json()),
        "batch_index": batch_index,
        "stats": stats_dict,
        "mode": mode,
        "file": path.name,
        "extra": extra or {},
    }
    tmp = d / "latest.json.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, d / "latest.json")
    return path


def load_latest(
    ckpt_dir, cfg: Config
) -> Optional[Tuple[int, object, dict, dict]]:
    """Return (batch_index, table, stats_dict, extra), or None if there
    is no checkpoint.

    Raises if the checkpoint's config is incompatible (another k,
    canonical, table mode, batch geometry, capacity or count dtype:
    resuming under different semantics would silently corrupt counts).
    The table stays on the host (numpy): `restore_state` places it."""
    d = Path(ckpt_dir)
    meta_path = d / "latest.json"
    if not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    saved_cfg = Config(**meta["config"])
    for field in (
        "k", "canonical", "chunk_len", "batch_rows",
        "sparse_capacity", "count_dtype",
    ):
        if getattr(saved_cfg, field) != getattr(cfg, field):
            raise ValueError(
                f"checkpoint config mismatch on {field!r}: "
                f"{getattr(saved_cfg, field)} != {getattr(cfg, field)}"
            )
    # table_mode compares RESOLVED (auto and an explicit spelling of the
    # same mode are compatible); devices and merge are not checked: a
    # checkpoint restores across mesh widths
    if saved_cfg.resolved_table_mode != cfg.resolved_table_mode:
        raise ValueError(
            f"checkpoint config mismatch on table mode: "
            f"{saved_cfg.resolved_table_mode} != {cfg.resolved_table_mode}"
        )
    data = np.load(d / meta["file"])
    if meta["mode"] == "direct":
        table = table_mod.DenseTable(counts=data["counts"], k=cfg.k)
    else:
        table = SparsePlanes(hi=data["hi"], lo=data["lo"], cnt=data["cnt"],
                             overflow=data["overflow"], k=cfg.k)
    return meta["batch_index"], table, meta.get("stats", {}), \
        meta.get("extra", {})
