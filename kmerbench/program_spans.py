"""The program's own spans and counters (`findkmer_torch.utils.prof`) in
the traced window, for the per-layer readers that read them.

The program's tracer is on while a torch.profiler session runs, as it
does over a traced window, and keeps its records in memory on
`time.perf_counter`'s clock, the clock of `spans.Recorder`.  The window
runs from the first `job` span's start to the last one's end; a record
is in it when it lies wholly inside.  Every function gives None where
there is nothing to read: a program without the tracer, one that dropped
records inside the window, or no record of the name there.  Nothing is
imported from the program until a reader runs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def window(r) -> Optional[Tuple[list, list]]:
    """(span records, counter records) of the program's tracer inside
    the window of the harness's Reading `r`; None as above."""
    try:
        from findkmer_torch.utils.prof import snapshot
    except ImportError:
        return None
    jobs = [s for s in r.spans if s.name == "job"]
    if not jobs:
        return None
    a, b = min(s.t0 for s in jobs), max(s.t1 for s in jobs)
    snap = snapshot()
    if snap.dropped_until is not None and snap.dropped_until >= a:
        return None
    spans: List = []
    counts: List = []
    for x in snap.records:
        if hasattr(x, "t1"):
            if a <= x.t0 and x.t1 <= b:
                spans.append(x)
        elif a <= x.t <= b:
            counts.append(x)
    return spans, counts


def self_s_per_gbase(r, name: str) -> Optional[float]:
    """Self time of the spans `name` in the window, s a Gbase of input."""
    w = window(r)
    if w is None:
        return None
    mine = [s.self_s for s in w[0] if s.name == name]
    return sum(mine) / r.gbases if mine else None


def counter(r, name: str) -> Optional[int]:
    """The counter `name`'s adds in the window, summed."""
    w = window(r)
    if w is None:
        return None
    mine = [c.value for c in w[1] if c.name == name]
    return sum(mine) if mine else None


def share(r, part: str, whole: str) -> Optional[float]:
    """100 x counter `part` / counter `whole` over the window."""
    p, q = counter(r, part), counter(r, whole)
    return None if p is None or not q else 100.0 * p / q
