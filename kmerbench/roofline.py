"""A kernel's share of its roofline over a traced window: for every launch
the least time the card could take, its bytes (inputs read once, outputs
written once, as each reader counts them) at the card's memory rate,
summed and divided by the device time of the kernel's launches in the
trace, summed.  None where the window launched the kernel nowhere."""

from __future__ import annotations

import re

from kmerbench.peaks import HBM_BYTES_PER_S


def share(r, hook_names, pattern: re.Pattern):
    nbytes = [b for name, b in r.launches if name in hook_names]
    if not nbytes or r.trace is None:
        return None
    a, b = r.trace.window
    device = sum(e.t1 - e.t0 for e in r.trace.kernels(pattern)
                 if a <= e.t0 <= b)
    if device <= 0:
        return None
    return 100.0 * sum(nbytes) / HBM_BYTES_PER_S / device
