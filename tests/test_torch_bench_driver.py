"""The port's benchmark driver (`findkmer_torch/bench/driver.py`) against
the repository's `bench.py`, and the rest of the reference's
`bench/steps.py` (`time_finalize`, `table_mode`, `bench_end_to_end`), on
the CPU.

The call plan and the output lines are compared with the steps replaced
by recorders that return fixed numbers, so both drivers run in this
process at once; the reference's health probe answers 0.0 and every
number clears its `EXPECT`, so it makes one pass.  The steps themselves
run at a small geometry and are held to the JAX package's counter on the
same wire: counts are integers, equality is exact.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import steps as jax_steps
from findkmer_tpu import pipeline as jax_pipeline
from findkmer_tpu.config import Config as JaxConfig
from findkmer_tpu.models.counter import KmerCounter as JaxCounter
from findkmer_torch import pipeline
from findkmer_torch.bench import driver, steps

torch.set_num_threads(1)  # six test workers share the cores

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fields of bench.py's lines that the port leaves out (its module
# docstring says why)
LEFT_OUT = {"vs_baseline", "health_probes_s"}


def _load_bench_script():
    """bench.py as a module of its own name: `bench` is also the
    repository's root package, which bench.py itself imports."""
    spec = importlib.util.spec_from_file_location(
        "bench_script_under_test", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixed_rate(kw) -> float:
    """A distinct rate for each call, above every EXPECT of bench.py, so
    its lines can be told apart and it makes one pass."""
    return 1e9 * (2 + kw.get("k", 0) / 100 + kw.get("canonical", False) / 2
                  + kw.get("batch_rows", 256) / 1e4)


def _recorders(calls):
    """bench_dense_step / bench_sparse_step stand-ins: record (name,
    keywords), return fixed numbers of the real functions' shape."""

    def dense(_dev, **kw):
        calls.append(("bench_dense_step", kw))
        return _fixed_rate(kw), 0.25

    def sparse(_dev, **kw):
        calls.append(("bench_sparse_step", kw))
        rate, dt = _fixed_rate(kw), 0.5 + kw.get("k", 0) / 1000
        if kw.get("time_finalize"):
            return rate, dt, 1.5
        return rate, dt

    return dense, sparse


@pytest.fixture
def both_drivers(monkeypatch):
    """(reference module, its calls, port calls) with the steps recorded
    in both drivers' namespaces."""
    ref = _load_bench_script()
    ref_calls, port_calls = [], []
    dense, sparse = _recorders(ref_calls)
    monkeypatch.setattr(ref, "bench_dense_step", dense)
    monkeypatch.setattr(ref, "bench_sparse_step", sparse)
    monkeypatch.setattr(ref, "_probe_health", lambda *a: 0.0)
    monkeypatch.setattr(ref, "setup_jax", lambda: jax)
    dense, sparse = _recorders(port_calls)
    monkeypatch.setattr(driver, "bench_dense_step", dense)
    monkeypatch.setattr(driver, "bench_sparse_step", sparse)
    return ref, ref_calls, port_calls


def test_call_plan_equals_reference(both_drivers):
    ref, ref_calls, port_calls = both_drivers
    want = ref._measure(jax)
    got = driver._measure(CPU)
    assert port_calls == ref_calls
    assert [name for name, _ in port_calls] == ["bench_dense_step"] + \
        ["bench_sparse_step"] * 4
    # the reference keeps its finalize seconds as a (s, s) pair; the
    # port keeps the one number
    fin, fin_again = want.pop("finalize_merge_s_k21")
    assert fin == fin_again
    assert got.pop("finalize_merge_s_k21") == fin
    assert got == want


def _run_mains(ref, capsys):
    """Both mains -> {driver: (stdout JSON lines, stderr JSON lines)}."""
    out = {}
    for name, main in (("reference", ref.main), ("port", driver.main)):
        args = () if name == "reference" else (["--device", "cpu"],)
        assert main(*args) == 0
        o, e = capsys.readouterr()
        out[name] = ([json.loads(ln) for ln in o.splitlines()],
                     [json.loads(ln) for ln in e.splitlines()])
    return out


def test_one_pass_and_streams_equal_reference(both_drivers, capsys):
    ref, ref_calls, port_calls = both_drivers
    lines = _run_mains(ref, capsys)
    ref_out, ref_err = lines["reference"]
    port_out, port_err = lines["port"]
    # the reference made one pass (five calls), as the port does
    assert len(ref_calls) == len(port_calls) == 5
    ref_err = [d for d in ref_err if d["metric"] != "tunnel_health_d2h_4mb"]
    assert [d["metric"] for d in port_err] == [d["metric"] for d in ref_err]
    assert [d["metric"] for d in port_err] == [
        *driver.SPARSE_METRICS, "finalize_merge_s_k21"]
    assert len(port_out) == len(ref_out) == 1
    assert port_out[0]["metric"] == "bases_per_s_per_chip_k8"


@pytest.mark.parametrize("metric", [*driver.SPARSE_METRICS,
                                    "finalize_merge_s_k21",
                                    "bases_per_s_per_chip_k8"])
def test_line_equals_reference(both_drivers, capsys, metric):
    """Each metric's line: the reference's keys in its order less
    LEFT_OUT, and equal values but for `device` (the port names the
    card, or "cpu")."""
    ref, _, _ = both_drivers
    lines = _run_mains(ref, capsys)
    found = {}
    for name, (out, err) in lines.items():
        for stream, ds in (("stdout", out), ("stderr", err)):
            for d in ds:
                if d["metric"] == metric:
                    found[name] = (stream, d)
    (ref_stream, want), (port_stream, got) = found["reference"], \
        found["port"]
    assert port_stream == ref_stream
    assert list(got) == [key for key in want if key not in LEFT_OUT]
    for key, value in got.items():
        if key == "device":
            assert value == "cpu"
        else:
            assert value == want[key], key
    if metric == "finalize_merge_s_k21":
        assert got["windows"] == 512 * 65536 * 3
        assert got["pass_values_s"] == [1.5] and got["unit"] == "s"
    elif "pass_values_mbase_s" in got:
        assert got["pass_values_mbase_s"] == [round(got["value"] / 1e6)]


def test_driver_runs_the_real_steps(monkeypatch, capsys):
    """The driver over the port's real steps, each call's geometry cut
    (rows / 128, chunk 1024, one step): five lines, positive numbers."""

    def small(fn):
        def call(dev, **kw):
            rows = kw.get("batch_rows", 1024) // 128
            return fn(dev, **{**kw, "batch_rows": rows, "chunk_len": 1024,
                              "steps": 1})
        return call

    monkeypatch.setattr(driver, "bench_dense_step",
                        small(steps.bench_dense_step))
    monkeypatch.setattr(driver, "bench_sparse_step",
                        small(steps.bench_sparse_step))
    assert driver.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    (k8,) = [json.loads(ln) for ln in out.splitlines()]
    lines = [json.loads(ln) for ln in err.splitlines()]
    assert k8["metric"] == "bases_per_s_per_chip_k8" and k8["value"] > 0
    assert [d["metric"] for d in lines] == [*driver.SPARSE_METRICS,
                                            "finalize_merge_s_k21"]
    assert all(d["value"] > 0 and d["device"] == "cpu" for d in lines)


# ---- the staged sparse step: time_finalize and table_mode -----------------

SMALL = dict(batch_rows=8, chunk_len=1024, steps=2)


def _jax_store(k, canonical, table_mode, batch_rows, chunk_len, steps):
    """The JAX counter over the reference's wire at the same geometry,
    ingested `steps` times, compacted and finalized."""
    cfg = JaxConfig(k=k, canonical=canonical, batch_rows=batch_rows,
                    chunk_len=chunk_len, sparse_capacity=1 << 28,
                    sparse_expected_entries=batch_rows * chunk_len * steps,
                    table_mode=table_mode)
    counter = JaxCounter(cfg)
    rng = np.random.default_rng(0)
    R = cfg.row_len
    work = rng.integers(0, 4, (batch_rows - 1) * chunk_len + R,
                        dtype=np.uint8)
    wire = tuple(jnp.asarray(a) for a in jax_pipeline._numpy_pack_rows(
        work, batch_rows, chunk_len, R, (R + 7) // 8 * 8))
    state = counter.init_state()
    for _ in range(steps):
        state = counter.step(state, wire)
    return counter.finalize(counter.compact(state))


SPARSE_CASES = [(8, False, "sparse"), (15, False, "auto"),
                (21, False, "auto"), (21, True, "auto")]


@pytest.mark.parametrize("k, canonical, table_mode", SPARSE_CASES,
                         ids=["k8_sparse", "k15", "k21", "k21_canonical"])
def test_sparse_step_time_finalize_equals_jax(k, canonical, table_mode):
    """`_sparse_run(time_finalize=True)` -> (counter, state, seconds,
    finalize seconds), its store finalized equal to the JAX counter's on
    the same wire; `bench_sparse_step` returns the reference's 3-tuple."""
    counter, state, dt, fin = steps._sparse_run(
        CPU, k=k, canonical=canonical, table_mode=table_mode,
        time_finalize=True, **SMALL)
    assert counter.mode == "sparse" and dt > 0 and fin > 0
    codes, counts = counter.finalize(state)
    want_codes, want_counts = _jax_store(k, canonical, table_mode, **SMALL)
    np.testing.assert_array_equal(codes, want_codes)
    np.testing.assert_array_equal(counts, want_counts)
    assert int(counts.sum()) == SMALL["batch_rows"] * SMALL["chunk_len"] * \
        SMALL["steps"]
    out = steps.bench_sparse_step(CPU, k=k, canonical=canonical,
                                  table_mode=table_mode, time_finalize=True,
                                  **SMALL)
    assert len(out) == 3 and all(x > 0 for x in out)
    assert len(steps.bench_sparse_step(CPU, k=k, canonical=canonical,
                                       table_mode=table_mode,
                                       **SMALL)) == 2


def test_reference_sparse_step_time_finalize_shape():
    """The reference's own step at the same small geometry gives the
    same shapes of result as the port's (3-tuple with time_finalize)."""
    out = jax_steps.bench_sparse_step(jax, k=21, time_finalize=True,
                                      **SMALL)
    ours = steps.bench_sparse_step(CPU, k=21, time_finalize=True, **SMALL)
    assert len(out) == len(ours) == 3


def test_sparse_run_finalize_timers():
    """`timers` collects the timed finalize's sub-phases."""
    from findkmer_torch.utils.prof import PhaseTimers

    timers = PhaseTimers()
    steps._sparse_run(CPU, k=21, time_finalize=True, timers=timers, **SMALL)
    assert {"finalize/compact", "finalize/global_sort",
            "finalize/d2h"} <= set(timers.totals)
    assert timers.counts["finalize/compact"] == 1


# ---- bench_end_to_end --------------------------------------------------------

@pytest.mark.parametrize("k", [4, 8])
def test_bench_end_to_end_equals_reference(fixtures_dir, monkeypatch, k):
    """A FASTA counted end to end: the same Config, and the bases of the
    reference's StreamStats."""
    path = os.path.join(fixtures_dir, "ecoli_frag.fa")
    seen = {}
    orig = pipeline.count_file

    def tapped(p, cfg, device, **kw):
        seen["cfg"] = cfg
        seen["spectrum"] = orig(p, cfg, device, **kw)
        seen["bases"] = kw["stats"].bases
        return seen["spectrum"]

    monkeypatch.setattr(pipeline, "count_file", tapped)
    bps, dt = steps.bench_end_to_end(CPU, path, k=k)
    assert bps > 0 and dt > 0
    ref_cfg = JaxConfig(k=k, hist="auto", batch_rows=64, chunk_len=65536)
    assert dataclasses.asdict(seen["cfg"]) == dataclasses.asdict(ref_cfg)
    stats = jax_pipeline.StreamStats()
    want = jax_pipeline.count_file(path, ref_cfg, stats=stats)
    assert seen["bases"] == stats.bases == round(bps * dt)
    np.testing.assert_array_equal(seen["spectrum"], want)
    ref_bps, ref_dt = jax_steps.bench_end_to_end(jax, path, k=k)
    assert round(ref_bps * ref_dt) == stats.bases
