"""The share of the traced window in which no kernel, memcpy or memset ran
on the card: 100 * (1 - busy / window)."""

from kmerbench import trace


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    a, b = r.trace.window
    return 100.0 * (1.0 - trace.busy_s(r.trace) / (b - a))
