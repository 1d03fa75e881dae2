"""One run of one cell: set-up, the measured window, the reference, the
result line.

Set-up: the cell's input is generated from the seed into memory, named
by paths in a directory of $TMPDIR (`gen/common.create`); the program (`findkmer_torch.cli.main`, in this process) runs
one warm-up job on it, which on a checkout's first run also builds the
kernels into the benchmark's cache (`build/kmerbench_cache/` of the
checkout).  The window: jobs back to back, one client, until `seconds`
have passed, closing at the end of the job running then.  Each job is the
cell's command line, its outputs written into named pipes that `sink.py`
drains.  After the window the device's peak is read, the program's state
freed, and the plain reference (`reference/<kind>.py`) works out every
byte a job must write; each job's streams are compared with them block by
block.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
CACHE = ROOT / "build" / "kmerbench_cache"
BANNED = ("jax", "jaxlib", "flax", "findkmer_tpu")
LAYERS = ("host_wait", "dispatch", "finalize", "write")
LIMITS = {"blocks_differing": 0, "bytes_gap": 0}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


@dataclass
class Job:
    t0: float
    t1: float
    rc: int
    streams: list
    bases: int


@dataclass
class Reading:
    """What the per-layer readers read of one traced window."""

    gbases: float
    spans: list
    launches: list
    samples: list  # (wall, self time of the four layers' spans)
    trace: object = None
    window_s: float = 0.0  # the window's wall, first job's start to last's end

    def per_gbase(self, layer: str) -> float:
        return sum(s.self_s for s in self.spans if s.name == layer) \
            / self.gbases


@dataclass
class Plan:
    """The argv of a job and the pipes it writes, in order."""

    argv: List[str]
    pipes: List[str]
    samples: bool = False


def plan_job(cell: Cell, inputs: List[str], work: str, device: str) -> Plan:
    from kmerbench.sink import make_pipe

    t = cell.traffic
    cmd = list(t["command"])
    argv = [cmd[0], *cell.config["flags"]]
    pipes: List[str] = []
    for word in cmd[1:]:
        if word == "{inputs}":
            argv += inputs
        elif word == "{out}":
            pipes = [make_pipe(os.path.join(work, "out.tsv"))]
            argv.append(pipes[0])
        elif word == "{outdir}":
            out = os.path.join(work, "out")
            os.makedirs(out)
            pipes = [make_pipe(os.path.join(
                out, os.path.splitext(os.path.basename(p))[0] + ".tsv"))
                for p in inputs]
            argv.append(out)
        else:
            argv.append(word)
    if device != "cuda":
        argv += ["--device", device]
    return Plan(argv, pipes, samples=t["output"] == "per_input")


def _run_job(plan: Plan, sink, rec, bases: int) -> Job:
    from findkmer_torch import cli

    sink.expect(plan.pipes)
    t0 = time.perf_counter()
    rc = 1
    try:
        with (rec.span("job") if rec else contextlib.nullcontext()):
            rc = cli.main(plan.argv)
    except BaseException as e:  # a job that raises is a failed job
        print(f"kmerbench: job raised {type(e).__name__}: {e}",
              file=sys.stderr)
        if not isinstance(e, Exception):
            raise
    t1 = time.perf_counter()
    streams = (sink.wait(len(plan.pipes)) if rc == 0
               else sink.abort(len(plan.pipes)))
    return Job(t0, t1, rc, streams, bases)


def _samples(jobs: List[Job], spans: list) -> list:
    """(wall, layer spans' self time) of every output of every job."""
    out = []
    for j in jobs:
        prev = j.t0
        for s in j.streams:
            inside = sum(sp.self_s for sp in spans if sp.name in LAYERS
                         and prev < sp.t0 <= s.t_close)
            out.append((s.t_close - prev, inside))
            prev = s.t_close
    return out


def expected(cell: Cell, inputs: List[str], device: str,
             variant: str = "exact") -> list:
    """The Digest of each stream one job must write, by the reference
    (`variant`: one of its controls)."""
    from kmerbench import blocks, reference

    ref = reference.load(cell.traffic["reference"])
    with ThreadPoolExecutor(4) as pool:
        return [blocks.digest_pieces(s, pool) for s in ref.streams(
            inputs, cell.config["k"], cell.config["canonical"], device,
            variant, **cell.traffic.get("reference_params", {}))]


def compare(got: List[list], want: list) -> dict:
    """Each number compared, summed over jobs; `got` has each job's
    Digests in order."""
    from kmerbench import blocks

    differing, gap = 0, 0
    for digests in got:
        for g, w in zip(digests, want):
            differing += blocks.blocks_differing(g, w)
            gap += abs(g.nbytes - w.nbytes)
        for w in want[len(digests):]:
            differing += len(w.crcs)
            gap += w.nbytes
    return {"blocks_differing": differing, "bytes_gap": gap}


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _trace_reading(prof, work: str):
    from kmerbench import trace

    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return trace.load(path)
    finally:
        os.unlink(path)


@dataclass
class Options:
    """What a test or a rehearsal changes of a run: the device it counts
    on, the traffic's generator parameters, a fault planted in the
    program."""

    device: str = "cuda"
    params: Optional[dict] = None
    fault: Optional[object] = None


def run(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
        opts: Optional[Options] = None) -> dict:
    """One run; -> the result object (the line's keys, in order)."""
    opts = opts or Options()
    import torch

    from kmerbench import gen, metrics, spans
    from kmerbench.sink import Sink

    cuda = opts.device == "cuda"
    # outputs are pipes: the program's buffered writer, its documented
    # opt-out of O_DIRECT (an O_DIRECT open of a pipe fails, and its
    # failed attempt would end the reader's stream before the fallback
    # writes it)
    direct_out = os.environ.get("FINDKMER_DIRECT_OUT")
    tmp = tempfile.mkdtemp(prefix="kmerbench.")
    sink = Sink(3)
    undo = []
    prof = None
    try:
        os.environ["FINDKMER_DIRECT_OUT"] = "0"
        work = os.path.join(tmp, "work")
        os.makedirs(work)
        t_gen = time.perf_counter()
        made = gen.load(cell.traffic["generator"]).generate(
            tmp, seed, opts.params or cell.traffic["params"])
        inputs, bases = made["inputs"], made["bases"]
        plan = plan_job(cell, inputs, work, opts.device)
        from findkmer_torch import cli  # noqa: F401  the program's import
        rec = spans.Recorder(annotate=traced) if traced else None
        readers = {m["name"]: metrics.load(m["name"]) for m in cell.per_layer}
        if traced:
            undo += spans.install_spans(rec)
            hooks = [h for r in readers.values()
                     for h in getattr(r, "HOOKS", [])]
            undo += spans.install_hooks(rec, hooks)
        if opts.fault is not None:
            undo += opts.fault()
        t_warm = time.perf_counter()
        warm = _run_job(plan, sink, None, bases)
        if warm.rc != 0:
            raise RuntimeError(f"the warm-up job exited {warm.rc}")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
            rec.clear()
        setup_s = time.perf_counter() - t_start
        jobs: List[Job] = []
        cpu0 = os.times()
        w0 = time.perf_counter()
        while True:
            jobs.append(_run_job(plan, sink, rec, bases))
            if time.perf_counter() - w0 >= seconds:
                break
        window = jobs[-1].t1 - jobs[0].t0
        cpu1 = os.times()
        cpu = (cpu1.user - cpu0.user, cpu1.system - cpu0.system)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        tr = None
        if prof is not None:
            prof.stop()
            tr = _trace_reading(prof, work)
            prof = None
        for u in reversed(undo):
            u()
        undo = []
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        compared = compare([[s.digest for s in j.streams] for j in jobs],
                           expected(cell, inputs, opts.device))
        print(f"kmerbench: {cell.name} seed {seed}: generated {bases} bases "
              f"and imported the program in {t_warm - t_gen:.3f} s; warm-up "
              f"job {warm.t1 - warm.t0:.3f} s; set-up {setup_s:.3f} s; "
              f"window {window:.3f} s, {len(jobs)} jobs; "
              f"reference and comparison {time.perf_counter() - t_ref:.3f} s",
              file=sys.stderr)
        walls = sorted(j.t1 - j.t0 for j in jobs)
        print(f"kmerbench: jobs' walls min {walls[0]:.3f} median "
              f"{statistics.median(walls):.3f} max {walls[-1]:.3f} s; the "
              f"process's CPU over the window {cpu[0]:.3f} s user, "
              f"{cpu[1]:.3f} s system", file=sys.stderr)
        failed = sum(j.rc != 0 for j in jobs)
        wall_bases = sum(j.bases for j in jobs)
        samples = (_samples(jobs, rec.spans if rec else [])
                   if plan.samples else [])
        if traced:
            reading = Reading(wall_bases / 1e9, rec.spans, rec.launches,
                              samples, tr, window)
            values = {n: r.read(reading) for n, r in readers.items()}
            wanted = cell.per_layer
        else:
            values = {
                "bases_per_s": wall_bases / window,
                "setup_s": setup_s,
                "peak_device_gib": peak / 2 ** 30 if cuda else None,
            }
            wanted = cell.end_to_end
        out_metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in wanted if values.get(m["name"]) is not None}
        device = {"platform": "gpu" if cuda else opts.device,
                  "kind": torch.cuda.get_device_name() if cuda else "cpu",
                  "count": cell.chips, "memory_peak_bytes": peak}
        result = {"correct": failed == 0 and all(
                      compared[k] <= LIMITS[k] for k in LIMITS),
                  "attempted": len(jobs), "failed": failed,
                  "metrics": out_metrics, "device": device}
        if traced and tr is not None:
            from kmerbench import trace

            a, b = tr.window
            if cuda:
                device["busy_s"] = trace.busy_s(tr)
                device["window_s"] = b - a
                result["breakdown"] = trace.breakdown(tr)
        if cuda:
            device["power_limit"] = _power_limit()
        result["compared"] = {k: {"value": v, "limit": LIMITS[k]}
                              for k, v in compared.items()}
        return result
    finally:
        if prof is not None:
            prof.stop()
        for u in reversed(undo):
            u()
        sink.close()
        gen.common.release()
        shutil.rmtree(tmp, ignore_errors=True)
        if direct_out is None:
            os.environ.pop("FINDKMER_DIRECT_OUT", None)
        else:
            os.environ["FINDKMER_DIRECT_OUT"] = direct_out


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def emit(result: dict) -> None:
    """The compared numbers as the last lines on stderr; the result as the
    last line on stdout."""
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
