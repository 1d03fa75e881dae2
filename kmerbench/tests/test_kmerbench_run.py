"""A whole run of each cell on the CPU at its generator's `tiny` size (the
program with --device cpu, the sink, the spans, the reference): correct,
with the result's keys; and the command's refusals: no card, or a checkout
that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from kmerbench import gen, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
DEVICE_METRICS = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]
                  if m["source"] == "device_trace"}


def rehearse(cell_name, traced, seed=2**31 + 17, fault=None, seconds=0.3,
             device="cpu"):
    cell = harness.load_cell(cell_name)
    params = gen.load(cell.traffic["generator"]).tiny(cell.traffic["params"])
    return cell, harness.run(cell, seed, seconds, traced, time.perf_counter(),
                             harness.Options(device=device, params=params,
                                             fault=fault))


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_run_on_the_cpu_is_correct(cell_name, traced):
    cell, r = rehearse(cell_name, traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "compared"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["compared"] == {"blocks_differing": {"value": 0, "limit": 0},
                             "bytes_gap": {"value": 0, "limit": 0}}
    want = {m["name"] for m in (cell.per_layer if traced
                                else cell.end_to_end)} - DEVICE_METRICS
    assert set(r["metrics"]) == want  # no device metric from the CPU
    assert "busy_s" not in r["device"] and "breakdown" not in r


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_traced_run_on_the_card_reads_every_metric(card, cell_name):
    cell, r = rehearse(cell_name, True, device=card)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]


def _command(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "kmerbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", **kw)
    return env


def test_no_card_no_result():
    out = _command(ROOT, _env())
    assert out.returncode == 3 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kmerbench", tmp_path / "kmerbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, _env())
    assert out.returncode != 0 and out.stdout == ""
