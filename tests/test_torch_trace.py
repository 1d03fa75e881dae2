"""The port's tracer (`findkmer_torch/utils/prof.py`): spans nest per
thread with their self times; off, nothing is recorded and no
record_function is entered; under torch.profiler the spans are
`findkmer.*` ranges of the Chrome trace on the tracer's own times; the
CLI's `count`, `histo` and `count --per-input` record the four layer
spans with their sub-spans, and the sparse store's counters; the bounded
store counts what it drops."""

import gc
import glob
import json
import os
import statistics
import sys
import threading
import time

import pytest
import torch

from findkmer_torch import cli
from findkmer_torch.utils import prof

GEOM = ["--chunk-len", "256", "--batch-rows", "4",
        "--sparse-compact-entries", "4096"]
LAYERS = ("host_batches", "dispatch", "finalize", "write")


def _mine(since):
    """Span and counter records closed after `since`."""
    recs = prof.snapshot().records
    spans = [r for r in recs if isinstance(r, prof.SpanRecord)
             and r.t0 >= since]
    counts = [r for r in recs if isinstance(r, prof.CountRecord)
              and r.t >= since]
    return spans, counts


def _nest(tag):
    with prof.span(f"{tag}.outer"):
        time.sleep(0.004)
        with prof.span(f"{tag}.inner"):
            time.sleep(0.006)
            with prof.span(f"{tag}.leaf"):
                time.sleep(0.002)


@pytest.mark.parametrize("threads", [1, 3], ids=["one_thread",
                                                 "three_threads"])
def test_spans_nest_with_self_time_per_thread(threads):
    t0 = time.perf_counter()
    with prof.collecting(prof.PhaseTimers()):
        workers = [threading.Thread(target=_nest, args=(f"t{i}",))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    spans, _ = _mine(t0)
    for i in range(threads):
        by = {s.name.split(".")[1]: s for s in spans
              if s.name.startswith(f"t{i}.")}
        assert set(by) == {"outer", "inner", "leaf"}
        assert len({s.thread for s in by.values()}) == 1
        outer, inner, leaf = by["outer"], by["inner"], by["leaf"]
        assert outer.t0 <= inner.t0 <= leaf.t0 <= leaf.t1 <= inner.t1 \
            <= outer.t1
        assert leaf.self_s == pytest.approx(leaf.t1 - leaf.t0)
        assert inner.self_s == pytest.approx(
            (inner.t1 - inner.t0) - (leaf.t1 - leaf.t0))
        assert outer.self_s == pytest.approx(
            (outer.t1 - outer.t0) - (inner.t1 - inner.t0))
        assert outer.self_s >= 0.003 and inner.self_s >= 0.005
    assert len({s.thread for s in spans if s.name.endswith(".outer")}) \
        == threads


def test_threads_lose_no_record_or_total():
    """More threads than cores, switching every 10 us: every span and
    counter add of every thread is in the store and in the view."""
    timers = prof.PhaseTimers()
    t0 = time.perf_counter()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            for _ in range(300):
                with prof.span("stress"):
                    prof.count("stress.n", 1)

        with prof.collecting(timers):
            workers = [threading.Thread(target=work)
                       for _ in range(2 * os.cpu_count())]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    spans, counts = _mine(t0)
    n = 300 * len(workers)
    assert timers.counts["stress"] == n
    assert sum(1 for s in spans if s.name == "stress") == n
    assert sum(c.value for c in counts if c.name == "stress.n") == n


def test_tracing_off_records_nothing_and_enters_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    before = prof.snapshot()
    assert not torch.autograd._profiler_enabled()
    with prof.span("off.a"):
        with prof.span("off.b"):
            pass
    prof.count("off.n", 3)
    timers = prof.PhaseTimers()
    with timers.phase("off.timed"):
        pass
    assert entered == []
    assert prof.snapshot() == before
    # an explicit PhaseTimers still takes its own phase, as before
    assert dict(timers.counts) == {"off.timed": 1}
    assert prof.span("off.c") is prof.span("off.d")  # the shared no-op


@pytest.mark.parametrize("how", ["off", "collecting", "profiler"])
def test_enabled_is_the_on_off_rule(how):
    if how == "off":
        assert not prof.enabled()
    elif how == "collecting":
        with prof.collecting(prof.PhaseTimers()):
            assert prof.enabled()
        assert not prof.enabled()
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert prof.enabled()
        assert not prof.enabled()


def test_the_bounded_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(prof, "_store", prof.Store(4))
    with prof.collecting(prof.PhaseTimers()):
        for i in range(10):
            with prof.span(f"ring{i}"):
                pass
        prof.count("ring.n", 1)
    snap = prof.snapshot()
    assert [r.name for r in snap.records] == [
        "ring7", "ring8", "ring9", "ring.n"]
    assert snap.dropped == 7
    assert snap.records[0].t0 - 1e-3 < snap.dropped_until \
        <= snap.records[0].t0  # the end of ring6, the newest dropped


@pytest.fixture
def ecoli(fixtures_dir):
    return os.path.join(fixtures_dir, "ecoli_frag.fa")


def _argv(cmd, path, tmp_path):
    if cmd == "histo":
        return ["histo", "-i", path, "-k", "21", "--canonical", "-o",
                str(tmp_path / "h.txt")]
    if cmd == "per_input":
        return ["count", "--per-input", "-i", path, path, "-k", "21",
                "--canonical", "-o", str(tmp_path / "specs")]
    return ["count", "-i", path, "-k", "21", "--canonical", "-o",
            str(tmp_path / "o.tsv")]


SUBS = {
    "count": {"host_batches/stage", "batcher", "finalize/compact",
              "finalize/global_sort", "finalize/d2h", "write/format",
              "write/io"},
    "histo": {"host_batches/stage", "batcher", "finalize/compact",
              "finalize/global_sort", "finalize/histo", "finalize/assemble",
              "write/format", "write/io"},
    "per_input": {"sample", "host_batches/stage", "batcher",
                  "finalize/compact", "finalize/global_sort",
                  "finalize/d2h", "write/format", "write/io"},
}


def _inside(child, spans, name):
    return any(s.name == name and s.thread == child.thread
               and s.t0 <= child.t0 and child.t1 <= s.t1 for s in spans)


@pytest.mark.parametrize("cmd", sorted(SUBS))
def test_each_path_records_the_layers_and_their_sub_spans(cmd, ecoli,
                                                          tmp_path):
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert cli.main(_argv(cmd, ecoli, tmp_path) + GEOM
                        + ["--device", "cpu"]) == 0
    spans, counts = _mine(t0)
    names = {s.name for s in spans}
    assert set(LAYERS) | SUBS[cmd] <= names
    consumer = {s.thread for s in spans if s.name == "host_batches"}
    assert len(consumer) == 1
    batchers = [s for s in spans if s.name == "batcher"]
    assert batchers and all(s.thread not in consumer for s in batchers)
    for s in spans:
        parent = s.name.rsplit("/", 1)[0]
        if "/" in s.name and s.name != "finalize/assemble":
            assert _inside(s, spans, parent), s
    if cmd == "per_input":
        # each sample's chunks go to its file as they come: no gather
        assert "finalize/assemble" not in names
        samples = [s for s in spans if s.name == "sample"]
        assert len(samples) == 2
        for s in spans:
            if s.name in LAYERS:
                assert _inside(s, samples, "sample"), s
    # histo pulls and formats no spectrum entry: it bins them on the
    # device
    assert {c.name for c in counts} == {
        "raw_slots_sorted", "raw_slots_filled", "store_live",
        "store_slots"} | ({"histo_on_card"} if cmd == "histo" else {
            "entries_pulled", "entries_written"})


@pytest.mark.parametrize("cmd", sorted(SUBS))
def test_counters_stay_within_their_capacity(cmd, ecoli, tmp_path):
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert cli.main(_argv(cmd, ecoli, tmp_path) + GEOM
                        + ["--device", "cpu"]) == 0
    _, counts = _mine(t0)

    def values(name):
        return [c.value for c in counts if c.name == name]

    sorted_, filled = values("raw_slots_sorted"), values("raw_slots_filled")
    assert len(sorted_) == len(filled) >= 2  # one of each a compaction
    assert all(0 <= f <= s for f, s in zip(filled, sorted_))
    assert sum(filled) > 0
    live, slots = values("store_live"), values("store_slots")
    assert len(live) == len(slots) >= 1
    assert all(0 < v <= s for v, s in zip(live, slots))


def test_tracing_off_computes_no_store_counter(ecoli, tmp_path,
                                              monkeypatch):
    """Off, the counters the host holds anyway are offered to `count`
    (a flag check), and the sum over the store's distinct vector is not
    taken at all."""
    offered = []
    monkeypatch.setattr(prof, "count", lambda name, n: offered.append(name))
    assert cli.main(_argv("count", ecoli, tmp_path) + GEOM
                    + ["--device", "cpu"]) == 0
    assert "raw_slots_sorted" in offered
    assert not {"store_live", "store_slots"} & set(offered)


# the spans a profiled run shows as findkmer.* ranges, by command
PROFILED = {
    "count": ("host_batches", "batcher", "write/format", "write/io",
              "finalize"),
    "histo": ("host_batches", "batcher", "finalize/assemble",
              "write/format", "write/io"),
}


@pytest.mark.parametrize("cmd", sorted(PROFILED))
def test_profile_trace_holds_the_spans_on_the_tracers_times(cmd, ecoli,
                                                            tmp_path):
    t0 = time.perf_counter()
    logdir = tmp_path / "trace"
    # between a record's clock reading and its range's, no thread is made
    # to give up the GIL and no garbage collection runs
    interval = sys.getswitchinterval()
    sys.setswitchinterval(10.0)
    gc.disable()
    try:
        assert cli.main(_argv(cmd, ecoli, tmp_path) + GEOM
                        + ["--device", "cpu", "--profile", str(logdir)]) == 0
    finally:
        gc.enable()
        sys.setswitchinterval(interval)
    spans, _ = _mine(t0)
    (path,) = glob.glob(str(logdir / "trace.*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith("findkmer.")
                  and e.get("cat") != "gpu_user_annotation"]
    ranges = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        ranges.setdefault(e["name"][len("findkmer."):], []).append(e)
    mine = {}
    for s in sorted(spans, key=lambda s: s.t0):
        mine.setdefault(s.name, []).append(s)
    # one clock: the trace's microseconds less one offset (the median
    # of host_batches' pairs) are the tracer's perf_counter seconds
    offset = statistics.median(
        e["ts"] * 1e-6 - s.t0
        for e, s in zip(ranges["host_batches"], mine["host_batches"]))
    consumer = ranges["host_batches"][0]["tid"]
    for name in PROFILED[cmd]:
        assert len(ranges.get(name, [])) == len(mine[name]), name
        off = []
        for e, s in zip(ranges[name], mine[name]):
            start = e["ts"] * 1e-6 - offset
            end = start + e["dur"] * 1e-6
            # a span reads the clock, then opens or closes its range
            assert start >= s.t0 - 5e-4 and end >= s.t1 - 5e-4, (name, e, s)
            tol = max(1e-3, 0.05 * (s.t1 - s.t0))
            if start - s.t0 > tol or end - s.t1 > tol:
                off.append((e["ts"], e["dur"], s))
            # the producer's batches on a thread of their own
            assert (e["tid"] != consumer) == (name == "batcher"), name
        # the two readings are microseconds apart; a thread the OS takes
        # off its core in between (the suite runs in parallel) sets that
        # pair apart by its time off: one pair in 20, or one
        assert len(off) <= max(1, len(mine[name]) // 20), (name, off)
