"""The per-layer readers: the frozen byte formulas of K2, C1 and K3, the
idle share and breakdown of a synthetic trace, span self times, the
roofline share's arithmetic."""

import statistics
import time

import pytest
import torch

from kmerbench import harness, metrics, spans, trace
from kmerbench.peaks import HBM_BYTES_PER_S


def _hook(metric, fn_name=None):
    hooks = metrics.load(metric).HOOKS
    return [h for h in hooks if fn_name in (None, h[2])][0]


def test_c1_bytes_wire_in_codes_out():
    packed = torch.zeros(256, 16392, dtype=torch.uint8)
    valid = torch.zeros(256, 8196, dtype=torch.uint8)
    codes = torch.zeros(256 * 65556, dtype=torch.int64)
    nbytes = _hook("c1_roofline")[4]
    assert nbytes((packed, valid, 21, True), {"R": 65556}, codes) == \
        256 * 16392 + 256 * 8196 + 8 * 256 * 65556


def test_k3_bytes_keys_and_payload_twice():
    keys = torch.zeros(1024, 2048, dtype=torch.int64)
    vals = torch.zeros(1024, 2048, dtype=torch.int32)
    nbytes = _hook("k3_roofline")[4]
    assert nbytes((keys, vals), {}, None) == 2 * 1024 * 2048 * 12
    assert nbytes((keys,), {}, None) == 2 * 1024 * 2048 * 8


def test_k2_bytes_wire_in_table_out():
    packed = torch.zeros(256, 16386, dtype=torch.uint8)
    valid = torch.zeros(256, 8193, dtype=torch.uint8)
    rows = torch.zeros(256, 65543, dtype=torch.uint8)
    p = _hook("k2_roofline", "fused_window_histogram_packed_cuda")[4]
    r = _hook("k2_roofline", "fused_window_histogram_cuda")[4]
    assert p((packed, valid, 8, False, 65543), {}, None) == \
        256 * 16386 + 256 * 8193 + 4 * 4 ** 8
    assert r((rows, 8, False), {}, None) == 256 * 65543 + 4 * 4 ** 8


def _ev(name, cat, t0_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": t0_us, "dur": dur_us}


def _synthetic():
    return trace.from_events([
        _ev("kmerbench.job", "user_annotation", 0, 1000),
        _ev("kmerbench.write", "user_annotation", 600, 400),
        _ev("kmerbench.host_wait", "user_annotation", 0, 300),
        _ev("void (anonymous namespace)::window_codes(unsigned char const*)",
            "kernel", 100, 100),
        _ev("void (anonymous namespace)::sort_tiles<long, int, 10>(long*)",
            "kernel", 150, 150),  # overlaps the one before: union 100..300
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 500, 50),
        _ev("kmerbench.job", "gpu_user_annotation", 0, 1000),
        _ev("before the window", "kernel", -500, 100),
        _ev("aten::sort", "cpu_op", 0, 10),
    ])


def test_idle_share_and_busy_of_a_synthetic_trace():
    tr = _synthetic()
    assert tr.window == (0.0, 1e-3)
    flat = [t for span in trace.busy(tr) for t in span]
    assert flat == pytest.approx([1e-4, 3e-4, 5e-4, 5.5e-4])
    assert trace.busy_s(tr) == pytest.approx(2.5e-4)
    r = harness.Reading(1.0, [], [], [], tr)
    assert metrics.load("device_idle_share").read(r) == pytest.approx(75.0)
    assert metrics.load("device_idle_share").read(
        harness.Reading(1.0, [], [], [], None)) is None


def test_breakdown_names_ops_and_labels_gaps():
    b = trace.breakdown(_synthetic())
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "sort_tiles<long, int, 10>"
    assert "window_codes" in names
    gaps = b["idle_gaps"]
    assert gaps[0] == ["write", pytest.approx(4.5e-4)]  # 550..1000
    assert gaps[1][0] == "job" and gaps[1][1] == pytest.approx(2e-4)
    assert gaps[2] == ["host_wait", pytest.approx(1e-4)]  # 0..100


def test_roofline_share_arithmetic():
    tr = _synthetic()
    bound_s = 50e-6  # half of window_codes' 100 us
    r = harness.Reading(1.0, [], [("c1", bound_s * HBM_BYTES_PER_S)], [], tr)
    assert metrics.load("c1_roofline").read(r) == pytest.approx(50.0)
    assert metrics.load("k2_roofline").read(r) is None  # nothing launched
    r = harness.Reading(1.0, [], [("k3", 15e-6 * HBM_BYTES_PER_S)], [], tr)
    assert metrics.load("k3_roofline").read(r) == pytest.approx(10.0)


def test_span_self_times_nest():
    rec = spans.Recorder()
    with rec.span("job"):
        with rec.span("write"):
            time.sleep(0.02)
            with rec.span("finalize"):
                time.sleep(0.03)
            time.sleep(0.01)
    by = {s.name: s for s in rec.spans}
    assert by["finalize"].self_s == pytest.approx(0.03, abs=0.01)
    assert by["write"].self_s == pytest.approx(0.03, abs=0.01)
    assert by["job"].self_s < 0.01
    assert by["write"].t1 - by["write"].t0 == pytest.approx(
        by["write"].self_s + by["finalize"].self_s)
    r = harness.Reading(0.5, rec.spans, [], [], None)
    assert metrics.load("write_s_per_gbase").read(r) == pytest.approx(
        by["write"].self_s / 0.5)


def test_sample_overhead_is_the_median_of_wall_less_spans():
    r = harness.Reading(1.0, [], [], [(1.0, 0.9), (2.0, 1.7), (0.5, 0.1)])
    assert metrics.load("sample_overhead_s").read(r) == pytest.approx(0.3)
    assert metrics.load("sample_overhead_s").read(
        harness.Reading(1.0, [], [], [])) is None


def test_samples_take_the_spans_between_their_closes():
    S = spans.Span
    st = type("St", (), {})
    a, b = st(), st()
    a.t_close, b.t_close = 1.0, 3.0
    job = harness.Job(0.0, 3.0, 0, [a, b], 10)
    sp = [S("write", 0.5, 0.9), S("finalize", 1.5, 2.0), S("job", 0.0, 3.0)]
    got = harness._samples([job], sp)
    assert got == [(1.0, pytest.approx(0.4)), (2.0, pytest.approx(0.5))]
    assert statistics.median([w - s for w, s in got]) == pytest.approx(1.05)


def test_window_rate_and_sample_p90_of_the_traced_window():
    r = harness.Reading(0.5, [], [], [(1.0, 0.9), (2.0, 1.7), (0.5, 0.1)],
                        None, 2.0)
    assert metrics.load("window_bases_per_s").read(r) == pytest.approx(2.5e8)
    assert metrics.load("window_sample_p90_s").read(r) == pytest.approx(
        statistics.quantiles([1.0, 2.0, 0.5], n=10, method="inclusive")[8])
    empty = harness.Reading(0.5, [], [], [])
    assert metrics.load("window_bases_per_s").read(empty) is None
    assert metrics.load("window_sample_p90_s").read(empty) is None


@pytest.mark.parametrize("name", [
    "host_wait_s_per_gbase", "dispatch_s_per_gbase", "finalize_s_per_gbase",
    "write_s_per_gbase", "device_idle_share", "c1_roofline", "k3_roofline"])
def test_a_peak_metric_reads_as_its_namesake(name):
    a, b = metrics.load(name), metrics.load(f"peak.{name}")
    assert b.read is a.read
    assert getattr(b, "HOOKS", None) is getattr(a, "HOOKS", None)
