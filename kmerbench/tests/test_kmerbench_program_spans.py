"""The readers of the program's own spans and counters
(`program_spans.py`): each on synthetic records, the window's clipping,
dropped records and a program without the tracer; and in a traced CPU
run of each cell, the boundaries of the program's four layer spans
against `spans.py`'s, with the `record_function` ranges stubbed out."""

import contextlib
import gc
import statistics
import sys
import time

import pytest
import torch

from kmerbench import harness, metrics
from kmerbench.spans import Span
from kmerbench.tests.test_kmerbench_run import CELLS, rehearse

prof = pytest.importorskip("findkmer_torch.utils.prof")

# the window: two jobs, 10.0-12.0 and 12.5-14.0
JOBS = [Span("job", 10.0, 12.0), Span("job", 12.5, 14.0)]
GBASES = 0.5


def _span(name, t0, t1, self_s=None, thread=1):
    return prof.SpanRecord(name, t0, t1, t1 - t0 if self_s is None
                           else self_s, thread)


def _count(name, t, value):
    return prof.CountRecord(name, t, value)


RECORDS = [
    # before the window, and straddling its start: left out
    _span("write/format", 9.0, 9.5),
    _span("write/format", 9.9, 10.1),
    _count("raw_slots_filled", 9.9, 1000),
    _count("raw_slots_sorted", 9.9, 1000),
    # inside
    _span("write", 10.1, 11.0, self_s=0.3),
    _span("write/format", 10.2, 10.6),
    _span("write/io", 10.6, 10.8),
    _span("write/format", 12.6, 12.9, self_s=0.25),
    _span("write/io", 12.9, 13.0),
    _span("finalize/assemble", 11.0, 11.2),
    _span("finalize/assemble", 13.0, 13.05),
    _span("batcher", 10.0, 10.5, thread=2),
    _span("batcher", 12.5, 13.5, thread=2),
    _count("raw_slots_sorted", 11.0, 400),
    _count("raw_slots_filled", 11.0, 300),
    _count("raw_slots_sorted", 13.0, 400),
    _count("raw_slots_filled", 13.0, 100),
    _count("store_live", 11.1, 30),
    _count("store_slots", 11.1, 120),
    _count("store_live", 13.1, 10),
    _count("store_slots", 13.1, 40),
    # straddling its end, and after: left out
    _span("batcher", 13.9, 14.2, thread=2),
    _span("write/io", 14.5, 15.0),
    _count("store_live", 14.5, 40),
    _count("store_slots", 14.5, 40),
]

WANT = {
    "write_format_s_per_gbase": (0.4 + 0.25) / GBASES,
    "write_io_s_per_gbase": (0.2 + 0.1) / GBASES,
    "finalize_assemble_s_per_gbase": (0.2 + 0.05) / GBASES,
    "peak.finalize_assemble_s_per_gbase": (0.2 + 0.05) / GBASES,
    "batcher_s_per_gbase": (0.5 + 1.0) / GBASES,
    "peak.batcher_s_per_gbase": (0.5 + 1.0) / GBASES,
    "raw_fill_share": 100.0 * 400 / 800,
    "store_fill_share": 100.0 * 40 / 160,
}


def _start(rec):
    return rec.t0 if isinstance(rec, prof.SpanRecord) else rec.t


def _reading():
    return harness.Reading(GBASES, list(JOBS), [], [])


def _snapshot(records, dropped=0, until=None):
    return lambda: prof.Snapshot(list(records), dropped, until)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_on_synthetic_records(name, monkeypatch):
    monkeypatch.setattr(prof, "snapshot", _snapshot(RECORDS))
    got = metrics.load(name).read(_reading())
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("case", ["dropped_inside", "dropped_before",
                                  "nothing_in_window", "no_tracer"])
def test_a_reader_reads_nothing_where_it_cannot(name, case, monkeypatch):
    if case == "no_tracer":  # a program from before the tracer
        monkeypatch.delattr(prof, "snapshot")
    elif case == "nothing_in_window":
        monkeypatch.setattr(prof, "snapshot", _snapshot(
            [r for r in RECORDS if not 10.0 <= _start(r) <= 14.0]))
    else:
        until = 10.05 if case == "dropped_inside" else 9.95
        monkeypatch.setattr(prof, "snapshot",
                            _snapshot(RECORDS, dropped=3, until=until))
    got = metrics.load(name).read(_reading())
    if case == "dropped_before":
        assert got == pytest.approx(WANT[name])
    else:
        assert got is None


# the program's layer spans and spans.py's, by layer
PAIRS = {"host_wait": "host_batches", "dispatch": "dispatch",
         "finalize": "finalize", "write": "write"}


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_program_and_the_wrappers_time_the_same_layers(cell_name,
                                                           monkeypatch):
    """A traced CPU run at `tiny` size: every per-layer metric of the
    cell is printed, and the self time of each of the program's four
    layers (its span and the `<layer>/...` spans inside it) agrees with
    spans.py's wrapper of that layer to 5% or 2 ms over the window, in
    the median job (times the jobs)."""
    seen = []

    class Captured(harness.Reading):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

    monkeypatch.setattr(harness, "Reading", Captured)
    # The two spans of a layer read their clocks a few microseconds
    # apart. What runs there must not take time from one side alone:
    # record_function calls, which let go of the GIL to another thread
    # (the sink's, the batcher) that may keep it for milliseconds, a
    # switch of threads, a garbage collection. This test compares the
    # spans' boundaries, so the ranges are no-ops here (the Chrome
    # trace's are tests/test_torch_trace.py's).
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: contextlib.nullcontext())
    t0 = time.perf_counter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(10.0)
    gc.disable()
    try:
        cell, r = rehearse(cell_name, True)
    finally:
        gc.enable()
        sys.setswitchinterval(interval)
    assert r["correct"]
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer} - {
        m["name"] for m in cell.per_layer if m["source"] == "device_trace"}
    (reading,) = seen
    jobs = [s for s in reading.spans if s.name == "job"]
    assert min(j.t0 for j in jobs) > t0
    mine = [s for s in prof.snapshot().records
            if isinstance(s, prof.SpanRecord) and s.t0 > t0]

    def within(spans, job, name):
        return sum(s.self_s for s in spans
                   if (s.name == name or s.name.startswith(name + "/"))
                   and job.t0 <= s.t0 and s.t1 <= job.t1)

    for layer, name in PAIRS.items():
        theirs = [within(reading.spans, j, layer) for j in jobs]
        ours = [within(mine, j, name) for j in jobs]
        assert sum(theirs) > 0, layer
        # a thread the OS takes off its core between the two clock
        # readings of a pair puts that time on one side, in one job
        off = statistics.median(abs(o - t) for o, t in zip(ours, theirs))
        assert off * len(jobs) <= max(0.002, 0.05 * sum(theirs)), (
            layer, ours, theirs)
