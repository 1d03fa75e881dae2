"""Reading a torch.profiler Chrome trace of the measured window.

Device activity is every kernel, memcpy and memset event; the window is
from the first `kmerbench.job` range's start to the last one's end (the
trace's own clock, in microseconds); host spans are the `kmerbench.<layer>`
ranges of `spans.py`.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "kmerbench."


@dataclass
class Event:
    name: str
    t0: float  # seconds, trace clock
    t1: float


@dataclass
class Trace:
    device: List[Event]
    ranges: List[Event]  # kmerbench.* host ranges, the prefix dropped
    window: Tuple[float, float]

    def kernels(self, pattern: re.Pattern) -> List[Event]:
        return [e for e in self.device if pattern.search(e.name)]


def from_events(events: List[dict]) -> Optional[Trace]:
    """A Trace of Chrome-trace events; None without a job range."""
    device, ranges = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"]) * 1e-6
        ev = Event(e.get("name", ""), t0, t0 + float(e["dur"]) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(ev)
        elif ev.name.startswith(PREFIX) and cat != "gpu_user_annotation":
            ev.name = ev.name[len(PREFIX):]
            ranges.append(ev)
    jobs = [r for r in ranges if r.name == "job"]
    if not jobs:
        return None
    return Trace(device, ranges,
                 (min(j.t0 for j in jobs), max(j.t1 for j in jobs)))


def load(path: str) -> Optional[Trace]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return from_events(events)


def busy(tr: Trace) -> List[Tuple[float, float]]:
    """Merged intervals in which any device event ran, clipped to the
    window."""
    a, b = tr.window
    spans = sorted((max(e.t0, a), min(e.t1, b)) for e in tr.device
                   if e.t1 > a and e.t0 < b)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(tr: Trace) -> float:
    return sum(e - s for s, e in busy(tr))


def gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The idle intervals of the window."""
    a, b = tr.window
    out, at = [], a
    for s, e in busy(tr):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if b > at:
        out.append((at, b))
    return out


def label(tr: Trace, t: float) -> str:
    """The innermost host range open at t, "job" outside every layer's."""
    best = None
    for r in tr.ranges:
        if r.t0 <= t <= r.t1 and (best is None or r.t1 - r.t0
                                  < best.t1 - best.t0):
            best = r
    return best.name if best else "between_jobs"


def short_name(name: str) -> str:
    """A kernel's function name without its namespace and arguments."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:96]


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """Device operations by total time; the longest idle gaps by the host
    range open at their middle."""
    a, b = tr.window
    by_op: Dict[str, float] = {}
    for e in tr.device:
        if e.t1 > a and e.t0 < b:
            n = short_name(e.name)
            by_op[n] = by_op.get(n, 0.0) + min(e.t1, b) - max(e.t0, a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(tr, (s + e) / 2), e - s] for s, e in idle]}
