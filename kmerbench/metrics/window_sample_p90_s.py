"""The 90th percentile of every sample's wall in the traced window (from the
previous sample's output closing, or the call's start, to its own output
closing), with `statistics.quantiles(n=10, method="inclusive")`."""

import statistics


def read(r):
    walls = [wall for wall, _ in r.samples]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
