"""Host-side input sharding for several hosts.

Counterpart of the part of `findkmer_tpu/parallel/multihost.py` that
needs no process group: host h streams batches h, h + P, h + 2P, ... of
the deterministic global batch sequence (round-robin), so the hosts need
no coordination beyond their index, and each writes a PARTIAL spectrum
(counting is associative: the partials sum to the whole).  A process
group with a coordinator, and the collective merge of the partials over
it, are not yet ported: `initialize` refuses a coordinator.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """-> (num_processes, process_id) of this run; (1, 0) for one process.

    Arguments default from the environment (FINDKMER_COORDINATOR,
    FINDKMER_NUM_PROCESSES, FINDKMER_PROCESS_ID) so a launcher can export
    instead of passing flags.  Without a coordinator the hosts run
    independently; with one and several processes the call raises."""
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
        raise NotImplementedError(
            f"--coordinator {coordinator_address} with {num_processes} "
            "processes (a process group and its collective merge) is not "
            "yet ported to findkmer_torch (ROADMAP.md Queue 1 item 13); "
            "without it each process writes a partial spectrum"
        )
    return num_processes, process_id


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
