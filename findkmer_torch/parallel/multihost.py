"""Several hosts: input sharding, the process group, the collective merge.

Counterpart of `findkmer_tpu/parallel/multihost.py`.  Host h streams
batches h, h + P, h + 2P, ... of the deterministic global batch sequence
(round-robin), so the hosts need no coordination beyond their index, and
each counts a PARTIAL spectrum (counting is associative: the partials sum
to the whole).  Without a coordinator each host writes its partial (the
`findkmer merge` tail).  With one, `initialize` joins a
`torch.distributed` process group over gloo (the payloads are host numpy
arrays, as the reference's `process_allgather` is), and
`allgather_spectrum` ends the run in one collective merge: every host
returns the full spectrum.  A host's own devices are its mesh
(`parallel/dist.py`); the group is only for this merge.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterator, Optional, Tuple

import numpy as np

# seconds a process waits for the whole group to join (jax.distributed's
# default initialization timeout), and for each collective;
# FINDKMER_COORDINATOR_TIMEOUT overrides it
GROUP_TIMEOUT_S = 300.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """-> (num_processes, process_id) of this run; (1, 0) for one process.

    Arguments default from the environment (FINDKMER_COORDINATOR,
    FINDKMER_NUM_PROCESSES, FINDKMER_PROCESS_ID,
    FINDKMER_COORDINATOR_TIMEOUT) so a launcher can export instead of
    passing flags.  Without a coordinator the hosts run independently.
    With one ("host:port"; process 0 listens there), the process joins a
    gloo group of num_processes; a group that is not complete within
    FINDKMER_COORDINATOR_TIMEOUT seconds (default GROUP_TIMEOUT_S) is an
    error, never a hang."""
    coordinator_address = coordinator_address or os.environ.get(
        "FINDKMER_COORDINATOR"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("FINDKMER_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("FINDKMER_PROCESS_ID", "0"))
    if num_processes <= 1:
        return 1, 0
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes} "
            "processes"
        )
    if coordinator_address is not None:
        import torch.distributed as dist

        timeout_s = float(os.environ.get("FINDKMER_COORDINATOR_TIMEOUT",
                                         GROUP_TIMEOUT_S))
        try:
            dist.init_process_group(
                "gloo",
                init_method=f"tcp://{coordinator_address}",
                world_size=num_processes,
                rank=process_id,
                timeout=datetime.timedelta(seconds=timeout_s),
            )
        except (RuntimeError, TimeoutError) as e:  # DistStoreError too
            raise RuntimeError(
                f"process {process_id} of {num_processes} could not join "
                f"the group at {coordinator_address} within {timeout_s:g} "
                f"s: {e}"
            ) from None
    return num_processes, process_id


def shutdown() -> None:
    """Leave the process group, if this process is in one: on every exit
    path of a run, so that a failed process closes its connections and
    its peers fail instead of waiting for it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_batches_round_robin(
    batches: Iterator, num_processes: int, process_id: int
) -> Iterator:
    """Deterministic host-side input sharding: host h takes the batch
    indices congruent to h mod P.  A pure function of the global batch
    sequence, so hosts need no coordination and resume composes
    (streaming.py)."""
    for i, b in enumerate(batches):
        if i % num_processes == process_id:
            yield b


def process_batch_count(total_batches: int, num_processes: int,
                        process_id: int) -> int:
    """How many batches the given host processes out of `total_batches`."""
    return (total_batches - process_id + num_processes - 1) // num_processes


def group_active() -> bool:
    """True when a process group of more than one process is up."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _allgather(a: np.ndarray) -> np.ndarray:
    """Every process's `a` (same shape and dtype everywhere), stacked in
    rank order."""
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def allgather_spectrum(spectrum):
    """Collective finalize across the group: every process contributes
    its PARTIAL spectrum and returns with the FULL merged one.

    Dense partials (np (4^k,) arrays) are gathered and summed (as the
    reference's, an int64 sum).  Sparse partials ((codes uint64, counts))
    are padded to the group's longest, gathered with the codes as int64
    views (real codes stay below 4^31, so the views are the same
    non-negative numbers), and merged on the host: the partials are
    sorted distinct runs, so the merge is one heap pass
    (`ops/sparse.merge_host_runs`)."""
    if not group_active():
        return spectrum
    if not isinstance(spectrum, tuple):  # dense partial table
        return _allgather(np.asarray(spectrum)).sum(axis=0)

    codes, counts = spectrum
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    lengths = _allgather(np.array([codes.size], np.int64)).reshape(-1)
    L = int(lengths.max())
    pad = L - codes.size
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint64)])
        counts = np.concatenate([counts, np.zeros(pad, np.int64)])
    all_codes = _allgather(codes.view(np.int64)).view(np.uint64)
    all_counts = _allgather(counts)
    from findkmer_torch.ops import sparse as sparse_ops

    runs = []
    for p in range(lengths.size):
        c = all_codes[p, : int(lengths[p])]
        n = all_counts[p, : int(lengths[p])]
        m = n > 0
        runs.append((c[m], n[m]))
    # the partials are sorted distinct runs -> one heap-merge pass
    return sparse_ops.merge_host_runs(runs)
