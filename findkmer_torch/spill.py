"""Disk-spill runs of the sparse store (external counting).

The port's copy of `findkmer_tpu/spill.py`, with the same run files, so
that either package loads the other's.  The sparse store is bounded by
device memory (Config.sparse_capacity distinct k-mers).  With
Config.spill_dir set, passing that ceiling is no error: the compacted
store, pulled as one globally sorted distinct (codes, counts) sequence,
is written to a run file on disk and the device store restarts empty.
Finalize is a streaming k-way block merge of every run and the residual
store, so host memory stays O(runs x block) however many distinct k-mers
the input holds: sorted runs and a merge, the external-memory design of
KMC and Gerbil.

Run files are plain .npy pairs (`run%05d.codes.npy` uint64,
`run%05d.counts.npy` int64) written atomically (tmp + rename, counts
before codes) and mmap-read at merge time, so a block slice never faults
a whole run into memory.  `stream.token` names the stream that owns the
directory's runs.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

Run = Tuple[np.ndarray, np.ndarray]  # (codes uint64 sorted distinct, counts)


def _save_atomic(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def _run_paths(dir_: str, idx: int) -> Tuple[str, str]:
    return (
        os.path.join(dir_, f"run{idx:05d}.codes.npy"),
        os.path.join(dir_, f"run{idx:05d}.counts.npy"),
    )


def write_run(dir_: str, idx: int, codes: np.ndarray,
              counts: np.ndarray) -> None:
    """Persist one sorted distinct run (atomic: readers never see a
    half-written file; counts land before codes so a complete codes
    file implies a complete run)."""
    os.makedirs(dir_, exist_ok=True)
    cp, np_ = _run_paths(dir_, idx)
    _save_atomic(np_, np.asarray(counts, dtype=np.int64))
    _save_atomic(cp, np.asarray(codes, dtype=np.uint64))


def _any_run_files(dir_: str) -> bool:
    """True if ANY run file exists, contiguous-from-0 or not — a crash
    midway through remove_runs (which deletes from index 0 upward) can
    leave a non-contiguous tail that load_runs' walk would miss."""
    import glob

    return bool(glob.glob(os.path.join(dir_, "run*.npy")))


def init_dir(dir_: str) -> None:
    """Create the spill dir; refuse one that already holds run files
    (a stale dir would silently merge another count's spectrum in).
    Stamps a fresh stream-identity token: checkpoint resume uses it to
    tell 'later runs of THIS stream' (safe to delete and replay) from
    a different count's runs (refused); see rowstore.adopt_spill_runs."""
    os.makedirs(dir_, exist_ok=True)
    if _any_run_files(dir_):
        raise ValueError(
            f"spill dir {dir_!r} already contains run files from "
            "another count; use an empty directory"
        )
    write_token(dir_)


_TOKEN_FILE = "stream.token"


def write_token(dir_: str, token: str | None = None) -> str:
    """Stamp the dir with a stream-identity token (atomic)."""
    import uuid

    token = token or uuid.uuid4().hex
    tmp = os.path.join(dir_, _TOKEN_FILE + ".tmp")
    with open(tmp, "w") as f:
        f.write(token)
    os.replace(tmp, os.path.join(dir_, _TOKEN_FILE))
    return token


def read_token(dir_: str) -> str | None:
    try:
        with open(os.path.join(dir_, _TOKEN_FILE)) as f:
            return f.read().strip() or None
    except OSError:
        return None


def remove_runs(dir_: str) -> None:
    """Delete every run file (called after a finalize consumed them)."""
    remove_runs_from(dir_, 0)


def remove_runs_from(dir_: str, start: int) -> None:
    """Delete run files with index >= start.

    Resume path: runs spilled AFTER the checkpoint being restored come
    from batches the resumed stream will replay — keeping them would
    double-count (rowstore.adopt_spill_runs).  Deletion globs
    rather than walking contiguous indices so a previous crash
    mid-delete (non-contiguous leftovers) cannot strand a stale tail."""
    import glob
    import re

    pat = re.compile(r"run(\d{5})\.(codes|counts)\.npy$")
    for path in glob.glob(os.path.join(dir_, "run*.npy")):
        m = pat.search(path)
        if m and int(m.group(1)) >= start:
            try:
                os.unlink(path)
            except OSError:
                pass


def load_runs(dir_: str) -> List[Run]:
    """mmap every run in `dir_` (contiguous run indices from 0)."""
    runs: List[Run] = []
    i = 0
    while True:
        cp, np_ = _run_paths(dir_, i)
        if not os.path.exists(cp):
            return runs
        runs.append((np.load(cp, mmap_mode="r"),
                     np.load(np_, mmap_mode="r")))
        i += 1


def _merge_block(parts_c, parts_n) -> Run:
    """Merge per-run sorted distinct slices: sum counts of duplicate
    codes, return sorted distinct arrays.  Delegates to the one shared
    implementation (ops/sparse.merge_host_runs: C heap-merge pass with
    numpy fallback; host only, no device work)."""
    from findkmer_torch.ops.sparse import merge_host_runs

    return merge_host_runs(list(zip(parts_c, parts_n)))


def iter_merged(
    runs: Sequence[Run], block: int = 1 << 22
) -> Iterator[Run]:
    """Streaming k-way merge of sorted distinct runs.

    Yields globally sorted distinct (codes uint64, counts int64) chunks
    whose concatenation is the exact sum-merge of the inputs.  Each
    round loads at most `block` entries per run; the emit bound is the
    minimum over all FULL blocks' maxima, so every code <= bound is
    complete (any unseen entry of a run exceeds its full block's max)
    and each round consumes at least one whole block (the bounding
    run's) — O(total/block) rounds, O(runs x block) resident."""
    act = [(c, n) for c, n in runs if len(c)]
    pos = [0] * len(act)
    while act:
        bounds = []
        for r, (c, _) in enumerate(act):
            end = min(pos[r] + block, c.shape[0])
            if end < c.shape[0]:
                bounds.append(np.uint64(c[end - 1]))
        bound = min(bounds) if bounds else None
        parts_c: List[np.ndarray] = []
        parts_n: List[np.ndarray] = []
        nxt_act, nxt_pos = [], []
        for r, (c, n) in enumerate(act):
            end = min(pos[r] + block, c.shape[0])
            blk = np.asarray(c[pos[r]:end])
            take = (
                blk.shape[0]
                if bound is None
                else int(np.searchsorted(blk, bound, side="right"))
            )
            if take:
                parts_c.append(blk[:take])
                parts_n.append(
                    np.asarray(n[pos[r]:pos[r] + take], dtype=np.int64)
                )
            p = pos[r] + take
            if p < c.shape[0]:
                nxt_act.append((c, n))
                nxt_pos.append(p)
        act, pos = nxt_act, nxt_pos
        if parts_c:
            yield _merge_block(parts_c, parts_n)
