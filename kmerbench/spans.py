"""Host spans and kernel-launch records around the program's layer calls,
installed in traced runs only (`--trace 1`).

A span is the host-clock interval of one call of a layer's entry, in the
thread that drives the count; spans nest, and each keeps its self time
(its length less the spans inside it), so the four layers' self times add
up to the job's wall less what lies outside every span.  In a profiled
window each span is also a `torch.profiler.record_function` range named
`kmerbench.<layer>`, so the device trace can say which layer the host was
in during an idle gap.

The wrapped entries (`SPANS`), by layer:
  host_wait  each next() of the iterator `pipeline.prefetch_for` returns:
             the step loop's wait for the next staged batch (reader, host
             batcher, H2D copy)
  dispatch   `KmerCounter.step` (the device step, the sparse compactions
             inside it)
  finalize   `KmerCounter.finalize`, and each next() of
             `KmerCounter.finalize_chunks` (compaction, global sort, D2H,
             host assembly)
  write      `cli._open_out` until the file it returns is closed,
             `output.write_spectrum`, `api.Spectrum.histo` (formatting,
             the writes, the histogram's reduction and lines)

A launch record is (hook name, bytes) of one call of a kernel's Python
entry that launched the kernel (its `launches` counter moved): the
roofline readers in `metrics/` name the entries and count the bytes.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


@dataclass
class Span:
    name: str
    t0: float
    t1: float = 0.0
    inner: float = 0.0

    @property
    def self_s(self) -> float:
        return self.t1 - self.t0 - self.inner


@dataclass
class Recorder:
    """Spans and launch records of the driving thread."""

    annotate: bool = False
    spans: List[Span] = field(default_factory=list)
    launches: List[Tuple[str, int]] = field(default_factory=list)
    stack: List[Tuple[Span, object]] = field(default_factory=list)
    thread: int = field(default_factory=threading.get_ident)

    def clear(self) -> None:
        self.spans.clear()
        self.launches.clear()

    def open(self, name: str) -> Optional[Span]:
        if threading.get_ident() != self.thread:
            return None
        rf = None
        if self.annotate:
            import torch

            rf = torch.profiler.record_function(f"kmerbench.{name}")
            rf.__enter__()
        span = Span(name, time.perf_counter())
        self.stack.append((span, rf))
        return span

    def close(self, span: Optional[Span]) -> None:
        if span is None:
            return
        span.t1 = time.perf_counter()
        while self.stack:
            top, rf = self.stack.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            if top is span:
                break
        if self.stack:
            self.stack[-1][0].inner += span.t1 - span.t0
        self.spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str):
        s = self.open(name)
        try:
            yield
        finally:
            self.close(s)


class _TimedIter:
    """An iterator whose next() calls are spans; close() passes on."""

    def __init__(self, it, rec: Recorder, name: str):
        self.it, self.rec, self.name = it, rec, name

    def __iter__(self):
        return self

    def __next__(self):
        with self.rec.span(self.name):
            return next(self.it)

    def close(self):
        if hasattr(self.it, "close"):
            self.it.close()


class _TimedFile:
    """The file `_open_out` returns, its life a span until close()."""

    def __init__(self, f, rec: Recorder, span: Optional[Span]):
        self.f, self.rec, self.s = f, rec, span

    def write(self, b):
        return self.f.write(b)

    def close(self):
        try:
            self.f.close()
        finally:
            self.rec.close(self.s)
            self.s = None


def _patch(obj, attr: str, make: Callable) -> Callable:
    """Replace obj.attr by make(original); -> a function that undoes it."""
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    return lambda: setattr(obj, attr, orig)


def install_spans(rec: Recorder) -> List[Callable]:
    """Wrap the layer entries of `SPANS` above; -> undo functions."""
    from findkmer_torch import api, cli, output, pipeline
    from findkmer_torch.models.counter import KmerCounter

    def call_span(name):
        def make(fn):
            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with rec.span(name):
                    return fn(*a, **kw)
            return wrapped
        return make

    def iter_span(name):
        def make(fn):
            @functools.wraps(fn)
            def wrapped(*a, **kw):
                return _TimedIter(fn(*a, **kw), rec, name)
            return wrapped
        return make

    def open_out(fn):
        @functools.wraps(fn)
        def wrapped(path):
            span = rec.open("write")
            f, close = fn(path)
            if not close:
                rec.close(span)
                return f, close
            return _TimedFile(f, rec, span), close
        return wrapped

    return [
        _patch(pipeline, "prefetch_for", iter_span("host_wait")),
        _patch(KmerCounter, "step", call_span("dispatch")),
        _patch(KmerCounter, "finalize", call_span("finalize")),
        _patch(KmerCounter, "finalize_chunks", iter_span("finalize")),
        _patch(cli, "_open_out", open_out),
        _patch(output, "write_spectrum", call_span("write")),
        _patch(api.Spectrum, "histo", call_span("write")),
    ]


def install_hooks(rec: Recorder, hooks) -> List[Callable]:
    """Record (name, bytes) for each launching call of each hook's entry.

    hooks: (name, module, function, counter, nbytes): `function` of
    `module` is wrapped wherever a loaded `findkmer_torch` module holds
    it; a call launched when `counter` of `module` (a function with a
    `launches` attribute) moved, and then nbytes(args, kwargs, result) is
    recorded under `name`."""
    undo = []
    for name, modname, fn_name, counter, nbytes in hooks:
        mod = importlib.import_module(modname)
        orig = getattr(mod, fn_name)

        def make(fn, mod=mod, counter=counter, nbytes=nbytes, name=name):
            @functools.wraps(fn)
            def wrapped(*a, **kw):
                before = getattr(mod, counter).launches
                out = fn(*a, **kw)
                if getattr(mod, counter).launches != before:
                    rec.launches.append((name, int(nbytes(a, kw, out))))
                return out
            return wrapped

        wrapped = make(orig)
        for m in list(sys.modules.values()):
            if (getattr(m, "__name__", "").startswith("findkmer_torch")
                    and getattr(m, fn_name, None) is orig):
                setattr(m, fn_name, wrapped)
                undo.append(functools.partial(setattr, m, fn_name, orig))
    return undo
