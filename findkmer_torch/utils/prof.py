"""Wall-clock phase timers (`--stats json`).

The port's copy of `PhaseTimers` of `findkmer_tpu/utils/prof.py`.  Device
work is asynchronous: a phase that must include it ends in a
`torch.cuda.synchronize()` or a device-to-host copy inside the `with`.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class PhaseTimers:
    """Accumulates wall time per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def as_dict(self) -> Dict[str, float]:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name]}
            for name in sorted(self.totals)
        }


def phases(timers):
    """`timers.phase`, or a no-op stand-in when there are no timers."""
    if timers is not None:
        return timers.phase
    return lambda name: contextlib.nullcontext()
