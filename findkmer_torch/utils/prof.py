"""The port's tracer: spans and counters, their phase totals
(`PhaseTimers`, `--stats json`), and the device trace (`--profile`).

Counterpart of `findkmer_tpu/utils/prof.py`, whose `PhaseTimers` is here
a view of the tracer.

A span is a named interval on the host's clock (`time.perf_counter`) in
one thread.  Spans nest per thread, and each keeps its self time: its
length less the spans closed inside it.  A counter is a named integer
that the program adds to beside its spans, from values the host already
holds.

Tracing is on while `collecting` runs (`count --stats json`), or while a
torch.profiler session is active in the process, in every thread (its
process-wide flag: `torch.autograd._profiler_enabled()` is the enabling
thread's alone, and False under `profile_all_threads`).  Off, a span is
a flag check: nothing is recorded and no `record_function` is entered.  On,
each closed span and each counter add is a record in a bounded ring
(`RING` records, the oldest dropped and counted; `snapshot` hands them
to in-process readers), and while a profiler runs each span is also a
`torch.profiler.record_function("findkmer.<name>")` range, so a Chrome
trace shows the program's spans beside the device's lanes on one clock.
No span or counter synchronises the device, reads a device tensor or
allocates on it.

A `PhaseTimers` takes the total and the calls of each span given it
(`span(name, timers)`, `timers.phase(name)`) and, inside `collecting`,
of every span closed in the process.  Device work is asynchronous: a
span that must include it ends in a synchronize or a device-to-host copy
inside the `with`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 1 << 20  # records the store keeps

_ON, _ANNOTATE = 1, 2


class SpanRecord(NamedTuple):
    name: str
    t0: float
    t1: float
    self_s: float
    thread: int


class CountRecord(NamedTuple):
    name: str
    t: float
    value: int


class Snapshot(NamedTuple):
    """The store's records, oldest first; `dropped` records went before
    them, the newest of which ended at `dropped_until` (None: none)."""

    records: list
    dropped: int
    dropped_until: Optional[float]


class Store:
    """A ring of the newest `size` records, and a count of the rest."""

    def __init__(self, size: int = RING):
        self.ring: deque = deque(maxlen=size)
        self.dropped = 0
        self.dropped_until: Optional[float] = None

    def add(self, rec) -> None:
        if len(self.ring) == self.ring.maxlen:
            old = self.ring[0]
            self.dropped += 1
            t = old.t1 if isinstance(old, SpanRecord) else old.t
            if self.dropped_until is None or t > self.dropped_until:
                self.dropped_until = t
        self.ring.append(rec)


class _Local(threading.local):
    def __init__(self):
        self.stack: List["_Span"] = []


_tl = _Local()
_lock = threading.Lock()
_store = Store()
_collector: Optional["PhaseTimers"] = None  # inside `collecting`


class _Span:
    __slots__ = ("name", "timers", "state", "t0", "inner", "rf")

    def __init__(self, name: str, timers, state: int):
        self.name, self.timers, self.state = name, timers, state
        self.inner = 0.0
        self.rf = None

    # the clock is read before each record_function call: the call lets
    # go of the GIL and reads the profiler's clock, then waits for the
    # GIL back, so the record and the range time the same interval
    def __enter__(self):
        _tl.stack.append(self)
        self.t0 = time.perf_counter()
        if self.state & _ANNOTATE:
            self.rf = torch.profiler.record_function(f"findkmer.{self.name}")
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _tl.stack
        # a span held across a generator's yield may close out of order
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        dur = t1 - self.t0
        if stack:
            stack[-1].inner += dur
        with _lock:
            if self.state & _ON:
                _store.add(SpanRecord(self.name, self.t0, t1,
                                      dur - self.inner,
                                      threading.get_ident()))
            if self.timers is not None:
                self.timers.add(self.name, dur)
            if _collector is not None and _collector is not self.timers:
                _collector.add(self.name, dur)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, timers: Optional["PhaseTimers"] = None):
    """A context manager timing its body as the span `name`, into the
    store while tracing is on and into `timers` when given; off and
    without timers, a shared no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, timers, _ON | _ANNOTATE)
    if _collector is not None:
        return _Span(name, timers, _ON)
    return _OFF if timers is None else _Span(name, timers, 0)


def enabled() -> bool:
    """Whether tracing is on: a caller computes a counter's value only
    then."""
    return _autograd_profiler._is_profiler_enabled or _collector is not None


def count(name: str, n: int) -> None:
    """Add `n` (a host integer) to the counter `name` while tracing is on."""
    if enabled():
        t = time.perf_counter()
        with _lock:
            _store.add(CountRecord(name, t, int(n)))


def snapshot() -> Snapshot:
    """A copy of the store's records, oldest first."""
    with _lock:
        return Snapshot(list(_store.ring), _store.dropped,
                        _store.dropped_until)


@contextlib.contextmanager
def collecting(timers: Optional["PhaseTimers"]):
    """Tracing on for the body, every span closed in it, in any thread,
    added to `timers`; a no-op for None.  One collector at a time."""
    global _collector
    if timers is None:
        yield None
        return
    if _collector is not None:
        raise RuntimeError("prof.collecting: a collector is already set")
    _collector = timers
    try:
        yield timers
    finally:
        _collector = None


class PhaseTimers:
    """Wall time and calls per span name: the spans given it, and inside
    `collecting` every span."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def phase(self, name: str):
        return span(name, self)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def as_dict(self) -> Dict[str, float]:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name]}
            for name in sorted(self.totals)
        }


def phases(timers):
    """`span(name, timers)` as a function of the name."""
    return lambda name: span(name, timers)


def _profile_config():
    """torch.profiler's option to record every thread (the producer's
    `batcher` spans), where this torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """torch.profiler over the body, its Chrome trace written to
    LOGDIR/trace.<pid>.json (the pid keeps the processes of a group
    apart); a no-op when logdir is None.  CPU activity of every thread
    where torch can record it, CUDA activity where torch has a card; the
    tracer's spans are its `findkmer.*` ranges."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    # record_function's first call resolves its ops (~1 ms): done here,
    # before the trace, it does not stretch the first span's range
    with torch.profiler.record_function("findkmer"):
        pass
    with profile(activities=activities,
                 experimental_config=_profile_config()) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace.{os.getpid()}.json"))
