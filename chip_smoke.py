"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of a checkout, on a machine with a CUDA card (Hopper,
sm_90a) and nvcc.  Each phase prints one line; any failure raises, so the
exit code is non-zero and the final ok-line is not printed.

  1. environment: torch, CUDA, capability (must be 9.0), nvcc, and the
     card's name and power limit as nvidia-smi reports them
  2. build: the CUDA kernels from findkmer_torch/csrc/ (one nvcc per
     source, in parallel), with build seconds, and the host encoder,
     which must be the C one ("native"): its numpy fallback gives the
     same output about ten times slower
  3. K1 (histogram) vs its plain twin on the card, exact equality: k in
     {1, 4, 6, 7, 8, 10}, both of the kernel's histograms (shared memory
     and global atomics) where k <= 6; random codes (~80% valid), one hot
     code, all invalid; shapes (3, 1000) and the production (1024, 65536).
     Then timing at the production shape, random codes 80% and 98% valid,
     k in {4, 6, 8, 10}: median CUDA-event times of the kernel (both
     histograms for k <= 6), of the plain scatter histogram (`index_add_`
     into a trash bin, no host sync: the `plain_ms` baseline, at 98%
     valid) and of the twin (`bincount(codes[valid])`, whose boolean mask
     syncs with the host)
  4. K3 (row sort) vs `sort_rows_reference` (torch.sort + gather) on the
     card, exact: keys equal, (key, count) pairs equal as multisets per
     row; cases random, all equal, all sentinel, sorted, reversed; shapes
     (3, 1000) and (64, 64) in every key/payload dtype, the production
     row sorts of a 256 Mbase count ((262144, 1024) int64 keys, (262144,
     2048) int64 keys + int32 counts, (262144, 1024) int32 keys) and one
     (1, 2^22) row, which takes the kernel's global passes.  Then the
     median CUDA-event ms of kernel and plain version at the production
     shapes, timed in turn (the kernel sorts in place, so each of its runs
     restores the input first; that copy is timed alone and subtracted)
  5. dense main path: a seeded 256 Mbase multi-record FASTA (N runs,
     lowercase, IUPAC codes, poly-A runs) counted by `findkmer_torch.cli
     count` at --batch-rows 1024 on cuda for k=8, k=8 --canonical and
     k=10; K1 must launch once per batch, and each output must equal the
     `--hist scatter` run byte for byte; beside it the rate of the host
     batcher alone and of the device step alone (batch staged on the card,
     with the share of its windows that are valid)
  6. sparse main path: the same genome at k=21 --canonical and k=15
     (row sort K3), each also run with the plain row sort; every row sort
     of every compaction must be a K3 launch, and the two outputs must
     hash equal (streamed sha256; each file is deleted once hashed).
     Prints bases/s and the CLI's phases, with the row sorts' device ms
  7. sparse device step: a staged k=21 --canonical batch: ingest ms,
     four compactions of the repeated batch at sparse_compact_entries =
     2^26 (raw, count-carrying, and one that squeezes first), each with
     its row sorts' device ms, then finalize ms
  8. oracle: tests/data fixtures at k=4, k=8, k=4 -z, k=11, k=21
     --canonical and k=31, byte-identical to oracle/scalar.py

With --profile, two more phases follow the dense main path: the FASTA
reader alone over the genome (no encode, no pack), and torch.profiler
over four steps of a staged k=8 batch on the kernel path, with the
device time of each kernel summed by name and the share of the steps'
wall time the device was busy.

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from findkmer_torch import Config, cli, pipeline
from findkmer_torch.models import counter as counter_mod
from findkmer_torch.models.counter import KmerCounter
from findkmer_torch.ops import histogram as hist_ops
from findkmer_torch.ops import sparse as sparse_ops
from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda import _build
from findkmer_torch.ops.cuda.histogram_kernel import (
    SHARED_MAX_K,
    histogram_cuda,
    histogram_reference,
)
from findkmer_torch.ops.cuda.rowsort_kernel import (
    sort_rows_cuda,
    sort_rows_reference,
)
from oracle.scalar import count_fasta_file, spectrum_lines

REPO = os.path.dirname(os.path.abspath(__file__))
PROD_SHAPE = (1024, 65536)
GENOME_BASES = 256 << 20
KERNEL_KS = (1, 4, 6, 7, 8, 10)
TIMED_KS = (4, 6, 8, 10)
# the check's share, and about that of a genome batch (N runs, IUPAC
# codes, record separators; the device_step line reports the real one)
TIMED_VALID = (0.8, 0.98)
STEP_KS = (8, 10)
# the row sorts of a 256 Mbase sparse count at 1024 x 65536 batches: the
# raw compaction (k=21, k=15) and the count-carrying one (k=21)
SORT_SHAPES = (
    ("raw_k21", (262144, 1024), torch.int64, None),
    ("counted_k21", (262144, 2048), torch.int64, torch.int32),
    ("raw_k15", (262144, 1024), torch.int32, None),
)
SORT_CASES = ("random", "equal", "sentinel", "sorted", "reversed")
SPARSE_RUNS = ((21, ["--canonical"]), (15, []))
ORACLE_RUNS = ((4, []), (8, []), (4, ["-z"]), (11, []),
               (21, ["--canonical"]), (31, []))


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is False; this script "
            "needs a CUDA card"
        )
    cap = torch.cuda.get_device_capability(0)
    nvcc = _build.nvcc_path()
    nvcc_ver = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say("environment", torch=torch.__version__, cuda=torch.version.cuda,
        capability=list(cap), nvcc=nvcc_ver,
        devices=torch.cuda.device_count())
    print(smi, flush=True)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: need compute capability 9.0, got {cap}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoder = pipeline.host_encoder()  # builds the C encoder if need be
    say("build", seconds=seconds,
        library=os.path.relpath(_build.library_path(), REPO),
        host_encoder=encoder,
        host_encoder_seconds=time.perf_counter() - t0)
    if encoder != "native":
        raise SystemExit(
            "chip_smoke: the C host encoder did not build (with $CC or "
            "cc); the numpy fallback would hide a tenfold slower host path"
        )


def _cases(k: int, shape, gen: torch.Generator):
    dev = torch.device("cuda")
    codes = torch.randint(0, 4 ** k, shape, generator=gen, device=dev,
                          dtype=torch.int32)
    valid = torch.rand(shape, generator=gen, device=dev) < 0.8
    yield "random", codes, valid
    hot = int(torch.randint(0, 4 ** k, (1,), generator=gen, device=dev))
    yield "hot", torch.full(shape, hot, dtype=torch.int32, device=dev), \
        torch.ones(shape, dtype=torch.bool, device=dev)
    yield "invalid", codes, torch.zeros(shape, dtype=torch.bool, device=dev)


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _check_equal(got, want, what: str) -> int:
    """-> max abs err, which must be 0: counts are exact."""
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if got.shape != want.shape or err:
        raise AssertionError(f"{what}: max abs err {err}")
    return err


def _time_alternating(fns: dict) -> dict:
    """Median CUDA-event ms of each fn, two sets run in turn (a b c a b c)
    so that each is timed in the same window as the others."""
    runs = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            runs[name].append(_median_ms(fn))
    return {name: {"ms": statistics.median(r), "runs": r}
            for name, r in runs.items()}


def phase_kernel(seed: int) -> int:
    """Kernel vs twin, exact, at every k, shape and case -> max abs err."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err = 0
    n_cases = 0
    for k in KERNEL_KS:
        paths = (True, False) if k <= SHARED_MAX_K else (False,)
        for shape in ((3, 1000), PROD_SHAPE):
            for name, codes, valid in _cases(k, shape, gen):
                want = histogram_reference(codes, valid, k)
                for shared in paths:
                    got = histogram_cuda(codes, valid, k, shared=shared)
                    max_err = max(max_err, _check_equal(
                        got, want, f"kernel (shared={shared}) != twin at "
                        f"k={k} shape={shape} case={name}"))
                    n_cases += 1
    say("kernel_vs_twin", cases=n_cases, max_abs_err=max_err)
    return max_err


def phase_timing(seed: int) -> dict:
    """Median CUDA-event ms at the production shape, random codes, for
    each k in TIMED_KS and valid share in TIMED_VALID: the kernel (and
    its global histogram where k <= 6), the plain scatter histogram
    (`index_add_` with invalid windows sent to a trash bin; no host
    sync) and the twin (`bincount(codes[valid])`, whose boolean mask
    syncs with the host).  The trash bin is one address, so the scatter
    slows with the invalid share."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dev = torch.device("cuda")
    timing = {}
    for k in TIMED_KS:
        table_size = 4 ** k
        for share in TIMED_VALID:
            codes = torch.randint(0, table_size, PROD_SHAPE, generator=gen,
                                  device=dev, dtype=torch.int32)
            valid = torch.rand(PROD_SHAPE, generator=gen, device=dev) < share
            want = histogram_reference(codes, valid, k)
            _check_equal(histogram_cuda(codes, valid, k), want,
                         f"kernel != twin at k={k} valid={share}")
            _check_equal(hist_ops.histogram(codes, valid, table_size), want,
                         f"scatter != twin at k={k} valid={share}")
            fns = {
                "plain": lambda: hist_ops.histogram(codes, valid, table_size),
                "kernel": lambda: histogram_cuda(codes, valid, k),
                "twin": lambda: histogram_reference(codes, valid, k),
            }
            if k <= SHARED_MAX_K:
                fns["kernel_global"] = lambda: histogram_cuda(
                    codes, valid, k, shared=False)
            timing[f"k{k}_valid{share}"] = _time_alternating(fns)
            del codes, valid
    say("kernel_timing", shape=list(PROD_SHAPE), timing=timing)
    return timing


def _sort_input(shape, kd, case, gen: torch.Generator) -> torch.Tensor:
    dev = torch.device("cuda")
    G, C = shape
    if case == "random":
        top = 4 ** 21 if kd == torch.int64 else 4 ** 15
        return torch.randint(0, top, shape, generator=gen, device=dev,
                             dtype=kd)
    if case == "equal":
        return torch.full(shape, 12345, dtype=kd, device=dev)
    if case == "sentinel":
        return torch.full(shape, torch.iinfo(kd).max, dtype=kd, device=dev)
    row = torch.arange(C, dtype=kd, device=dev)
    if case == "reversed":
        row = row.flip(0)
    return row.expand(G, C).contiguous()


def _vals_by_pair(keys, vals):
    """vals of each row ordered by (key, val) with two stable sorts:
    equal results mean equal (key, val) multisets per row."""
    o = torch.sort(vals, dim=1, stable=True).indices
    o = o.gather(1, torch.sort(keys.gather(1, o), dim=1, stable=True).indices)
    return vals.gather(1, o)


def phase_rowsort_vs_plain(seed: int) -> int:
    """K3 vs its plain version, exact, at every shape and case."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    dts = (torch.int32, torch.int64)
    combos = [(shape, kd, vd) for shape in ((3, 1000), (64, 64))
              for kd in dts for vd in (None,) + dts]
    combos += [(shape, kd, vd) for _, shape, kd, vd in SORT_SHAPES]
    combos.append(((1, 1 << 22), torch.int64, torch.int32))
    n_cases = 0
    for shape, kd, vd in combos:
        for case in SORT_CASES:
            keys = _sort_input(shape, kd, case, gen)
            vals = None if vd is None else torch.randint(
                0, 1 << 30, shape, generator=gen, device="cuda", dtype=vd)
            wk, wv = sort_rows_reference(keys, vals)
            gk, gv = sort_rows_cuda(keys, vals)  # in place on the inputs
            torch.cuda.synchronize()
            what = f"K3 != plain at {shape} {kd} vals={vd} case={case}"
            if not torch.equal(gk, wk):
                raise AssertionError(f"{what}: keys differ")
            if vals is not None and not torch.equal(
                    _vals_by_pair(gk, gv), _vals_by_pair(wk, wv)):
                raise AssertionError(f"{what}: (key, val) pairs differ")
            n_cases += 1
            del keys, vals, wk, wv, gk, gv
        torch.cuda.empty_cache()
    say("rowsort_vs_plain", cases=n_cases, max_abs_err=0)
    return 0


def phase_rowsort_timing(seed: int) -> dict:
    """Median CUDA-event ms of K3 and of the plain version at the
    production row-sort shapes, random codes, timed in turn.  The kernel
    sorts in place: each of its runs first restores the unsorted input
    (`copy`, timed alone too); its ms is kernel+copy minus copy."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    timing = {}
    for name, shape, kd, vd in SORT_SHAPES:
        src = _sort_input(shape, kd, "random", gen)
        vsrc = None if vd is None else torch.ones(shape, dtype=vd,
                                                  device="cuda")
        kbuf = torch.empty_like(src)
        vbuf = None if vsrc is None else torch.empty_like(vsrc)

        def copy():
            kbuf.copy_(src)
            if vbuf is not None:
                vbuf.copy_(vsrc)

        def kernel():
            copy()
            sort_rows_cuda(kbuf, vbuf)

        t = _time_alternating({
            "plain": lambda: sort_rows_reference(src, vsrc),
            "kernel+copy": kernel,
            "copy": copy,
        })
        t["kernel"] = {"ms": t["kernel+copy"]["ms"] - t["copy"]["ms"]}
        timing[name] = {"shape": list(shape), "keys": str(kd),
                        "vals": str(vd), **t}
        del src, vsrc, kbuf, vbuf
        torch.cuda.empty_cache()
    say("rowsort_timing", timing=timing)
    return timing


class _RowSortTap:
    """Counts every row sort of the sparse store (kernel or plain) by
    wrapping `ops.sparse.sort_rows`, and with `timed` records CUDA events
    around each, so a compaction's row-sort device ms can be read."""

    def __init__(self):
        self.calls = 0
        self.timed = False
        self.events = []
        self._orig = sparse_ops.sort_rows

    def __enter__(self):
        def tapped(*args, **kw):
            self.calls += 1
            if not self.timed:
                return self._orig(*args, **kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self._orig(*args, **kw)
            b.record()
            self.events.append((a, b))
            return out

        sparse_ops.sort_rows = tapped
        return self

    def __exit__(self, *exc):
        sparse_ops.sort_rows = self._orig

    def sort_ms(self) -> float:
        """Device ms of the row sorts recorded since the last call."""
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms


def _sha256_and_delete(path: str) -> tuple:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 24)
            if not block:
                break
            h.update(block)
    size = os.path.getsize(path)
    os.unlink(path)
    return h.hexdigest(), size


def phase_sparse_main_path(tmp: str, fasta: str) -> tuple:
    """The 256 Mbase genome through the CLI at k=21 --canonical and
    k=15: K3 on every row sort, outputs equal to the plain row sort's."""
    runs = []
    with _RowSortTap() as tap:
        tap.timed = True
        sort_rows_cuda.launches = 0
        histogram_cuda.launches = 0
        for k, extra in SPARSE_RUNS:
            digests = {}
            for row_sort in ("auto", "plain"):
                out = os.path.join(tmp, f"sparse_k{k}_{row_sort}.tsv")
                launches0, calls0 = sort_rows_cuda.launches, tap.calls
                tap.sort_ms()
                stats, wall = run_cli(
                    ["count", "-i", fasta, "-k", str(k), "--batch-rows",
                     "1024", "--chunk-len", "65536", "--device", "cuda",
                     "-o", out, "--stats", "json"] + extra,
                    row_sort=row_sort,
                )
                sort_ms = tap.sort_ms()
                launched = sort_rows_cuda.launches - launches0
                sorts = tap.calls - calls0
                want = sorts if row_sort == "auto" else 0
                if sorts == 0 or launched != want:
                    raise AssertionError(
                        f"k={k} row_sort={row_sort}: {launched} K3 launches "
                        f"for {sorts} row sorts"
                    )
                digest, size = _sha256_and_delete(out)
                digests[row_sort] = digest
                run = {"k": k, "args": extra, "row_sort": row_sort,
                       "row_sorts": sorts, "launches": launched,
                       "row_sort_device_ms": sort_ms,
                       "batches": stats["batches"], "bases": stats["bases"],
                       "bases_per_s": stats["bases_per_s"],
                       "cli_wall_s": stats["wall_s"], "wall_s": wall,
                       "out_bytes": size, "sha256": digest,
                       "host_encoder": stats["host_encoder"],
                       "phases": stats["phases"]}
                say("sparse_main_path", **run)
                runs.append(run)
                torch.cuda.empty_cache()
            if digests["auto"] != digests["plain"]:
                raise AssertionError(
                    f"k={k} {extra}: K3 output differs from the plain row "
                    "sort's output"
                )
            say("sparse_main_path_identical", k=k, args=extra,
                sha256=digests["auto"])
        if histogram_cuda.launches:
            raise AssertionError("the sparse path launched the histogram")
    return sort_rows_cuda.launches, runs


def phase_sparse_device_step(fasta: str) -> None:
    """A staged k=21 --canonical batch: ingest, four compactions of the
    repeated batch (raw; count-carrying; count-carrying; squeeze + count-
    carrying) at sparse_compact_entries = 2^26, then the finalize."""
    k = 21
    cfg = Config(k=k, canonical=True, batch_rows=PROD_SHAPE[0],
                 chunk_len=PROD_SHAPE[1], sparse_compact_entries=1 << 26,
                 sparse_capacity=1 << 28)
    counter = KmerCounter(cfg, torch.device("cuda"))
    batches = pipeline.batches_from_file(fasta, cfg)
    batch = counter.put_batch(next(batches))
    batches.close()
    n = counter_mod.batch_slots(batch, k, cfg.row_len)
    out = torch.empty(n, dtype=torch.int64, device="cuda")
    ingest_ms = _median_ms(
        lambda: counter_mod.ingest(out, batch, k, True, cfg.row_len),
        reps=10)
    valid_share = float((out != window_ops.sentinel(torch.int64))
                        .float().mean())
    del out
    comps = []
    with _RowSortTap() as tap:
        tap.timed = True
        state = counter.init_state()
        for _ in range(4):
            state = counter.step(state, batch)
            torch.cuda.synchronize()
            tap.sort_ms()
            calls0, launches0 = tap.calls, sort_rows_cuda.launches
            t0 = time.perf_counter()
            state = counter.compact(state)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            comps.append({"ms": ms, "row_sort_device_ms": tap.sort_ms(),
                          "row_sorts": tap.calls - calls0,
                          "launches": sort_rows_cuda.launches - launches0,
                          "store": list(state.store[0].shape)})
        sorts = [c["row_sorts"] for c in comps]
        if sorts[0] != 1 or 2 not in sorts or any(
                c["launches"] != c["row_sorts"] for c in comps):
            # raw first; a squeeze once the holes pass half the row
            raise AssertionError(f"unexpected compaction sequence {comps}")
        t0 = time.perf_counter()
        entries = sum(c.size for c, _ in counter.finalize_chunks(state))
        torch.cuda.synchronize()
        finalize_ms = 1e3 * (time.perf_counter() - t0)
    say("sparse_device_step", k=k, canonical=True, batch=list(PROD_SHAPE),
        slots=n, valid_share=valid_share, ingest_ms=ingest_ms,
        ingest_bases_per_s=PROD_SHAPE[0] * PROD_SHAPE[1] / ingest_ms * 1e3,
        compactions=comps, finalize_ms=finalize_ms,
        finalize_entries=entries)
    del state, counter, batch
    torch.cuda.empty_cache()


def write_genome(path: str, seed: int, total: int = GENOME_BASES) -> None:
    """A seeded multi-record FASTA of `total` bases: uniform ACGT with
    ~5% lowercase, ~0.1% IUPAC codes, a few N gaps and poly-A runs per
    record, 80 bases per line."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    iupac = np.frombuffer(b"RYSWKMBDHVN", np.uint8)
    cuts = np.unique(rng.integers(1, total, 23))  # 24 records, or fewer
    lens = np.diff(np.concatenate([[0], cuts, [total]]))
    with open(path, "wb") as f:
        for r, n in enumerate(lens):
            seq = acgt[rng.integers(0, 4, n, dtype=np.uint8)]
            low = rng.integers(0, 20, n, dtype=np.uint8) == 0
            seq[low] |= 0x20
            amb = np.flatnonzero(rng.integers(0, 1000, n, dtype=np.uint16) == 0)
            seq[amb] = iupac[rng.integers(0, iupac.size, amb.size)]
            for fill, runs, longest in ((ord("N"), 4, 50000),
                                        (ord("A"), 8, 5000)):
                for _ in range(runs):
                    ln = int(rng.integers(100, longest))
                    s = int(rng.integers(0, max(1, n - ln)))
                    seq[s : s + ln] = fill
            f.write(f">chr{r + 1} seeded record {r + 1}\n".encode())
            full = n // 80 * 80
            body = np.empty((full // 80, 81), np.uint8)
            body[:, :80] = seq[:full].reshape(-1, 80)
            body[:, 80] = ord("\n")
            f.write(body.tobytes())
            if n > full:
                f.write(seq[full:].tobytes() + b"\n")


def phase_layers(fasta: str) -> None:
    """Per-layer rates at the production geometry: the host batcher alone
    (no device), and the device step alone on a batch staged on the card,
    for the kernel and for --hist scatter."""
    cfg = Config(k=8, batch_rows=PROD_SHAPE[0], chunk_len=PROD_SHAPE[1])
    t0 = time.perf_counter()
    n_batches = 0
    for _ in pipeline.batches_from_file(fasta, cfg):
        n_batches += 1
    dt = time.perf_counter() - t0
    say("host_batches", batches=n_batches, seconds=dt,
        bases_per_s=GENOME_BASES / dt, host_encoder=pipeline.host_encoder())
    steps = 8
    for k in STEP_KS:
        for hist in ("pallas", "scatter"):
            kcfg = cfg.replace(k=k, hist=hist)
            counter = KmerCounter(kcfg, torch.device("cuda"))
            batches = pipeline.batches_from_file(fasta, kcfg)
            batch = counter.put_batch(next(batches))
            batches.close()
            rows = window_ops.rows_from_batch(batch, kcfg.row_len)
            valid_share = float(
                window_ops.window_codes(rows, k, False)[1].float().mean())
            del rows
            state = counter.init_state()
            for _ in range(2):
                state = counter.step(state, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state = counter.step(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            say("device_step", k=k, hist=hist, steps=steps,
                valid_share=valid_share,
                ms_per_step=1e3 * dt / steps,
                bases_per_s=steps * cfg.batch_rows * cfg.chunk_len / dt)


def phase_profile(fasta: str) -> None:
    """The FASTA reader alone, then torch.profiler over staged k=8 steps
    on the kernel path: device ms per step by kernel name."""
    cfg = Config(k=8, batch_rows=PROD_SHAPE[0], chunk_len=PROD_SHAPE[1])
    t0 = time.perf_counter()
    reader, _ = pipeline._open_reader(fasta, cfg)
    try:
        n_bytes = sum(len(c.data) for c in reader.chunks())
    finally:
        reader.close()
    dt = time.perf_counter() - t0
    say("host_reader", seconds=dt, bytes=n_bytes,
        bases_per_s=GENOME_BASES / dt, host_encoder=pipeline.host_encoder())

    from torch.profiler import ProfilerActivity, profile

    counter = KmerCounter(cfg, torch.device("cuda"))
    batches = pipeline.batches_from_file(fasta, cfg)
    batch = counter.put_batch(next(batches))
    batches.close()
    state = counter.init_state()
    for _ in range(3):
        state = counter.step(state, batch)
    torch.cuda.synchronize()
    steps = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(steps):
            state = counter.step(state, batch)
        b.record()
        b.synchronize()
    wall_ms = a.elapsed_time(b) / steps
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        # device events only: a CPU op's self device time repeats the
        # time of the kernels it launched
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if on_device and us > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3 / steps
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    say("profile_step", k=8, hist="pallas", steps=steps,
        wall_ms_per_step=wall_ms, device_ms_per_step=busy_ms,
        busy_share=busy_ms / wall_ms if wall_ms else None,
        kernels=[{"name": n[:80], "ms_per_step": ms,
                  "share": ms / busy_ms if busy_ms else None}
                 for n, ms in top])


def run_cli(args, row_sort: str = "auto") -> tuple:
    """findkmer_torch.cli.main(args) in this process -> (stats, wall_s)."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args, row_sort=row_sort)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {args} exited {rc}: {err.getvalue()}")
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("{")]
    return (json.loads(lines[-1]) if lines else None), wall


def phase_genome(tmp: str, seed: int) -> str:
    fasta = os.path.join(tmp, "genome.fa")
    t0 = time.perf_counter()
    write_genome(fasta, seed)
    free = shutil.disk_usage(tmp).free
    say("genome", bases=GENOME_BASES, bytes=os.path.getsize(fasta),
        seconds=time.perf_counter() - t0, tmp_free_bytes=free)
    return fasta


def phase_main_path(fasta: str, tmp: str, profile: bool) -> tuple:
    phase_layers(fasta)
    if profile:
        phase_profile(fasta)
    runs = []
    histogram_cuda.launches = 0
    sort_rows_cuda.launches = 0
    for k, extra in ((8, []), (8, ["--canonical"]), (10, [])):
        outs = {}
        for hist in ("auto", "scatter"):
            out = os.path.join(tmp, f"k{k}{''.join(extra)}_{hist}.tsv")
            before = histogram_cuda.launches
            stats, wall = run_cli(
                ["count", "-i", fasta, "-k", str(k), "--batch-rows", "1024",
                 "--chunk-len", "65536", "--device", "cuda", "--hist", hist,
                 "-o", out, "--stats", "json"] + extra
            )
            launched = histogram_cuda.launches - before
            want = stats["batches"] if hist == "auto" else 0
            if launched != want:
                raise AssertionError(
                    f"k={k} {extra} hist={hist}: kernel launched "
                    f"{launched} times for {stats['batches']} batches"
                )
            outs[hist] = out
            run = {"k": k, "args": extra, "hist": hist,
                   "batches": stats["batches"], "launches": launched,
                   "bases": stats["bases"], "cli_wall_s": stats["wall_s"],
                   "bases_per_s": stats["bases_per_s"], "wall_s": wall,
                   "device": stats["device"]}
            say("main_path", **run)
            runs.append(run)
        with open(outs["auto"], "rb") as a, open(outs["scatter"], "rb") as b:
            if a.read() != b.read():
                raise AssertionError(
                    f"k={k} {extra}: kernel output differs from --hist "
                    "scatter output"
                )
        say("main_path_identical", k=k, args=extra,
            bytes=os.path.getsize(outs["auto"]))
    launches = histogram_cuda.launches
    if sort_rows_cuda.launches:
        raise AssertionError("the dense path launched the row sort")
    return launches, runs


def phase_oracle(tmp: str) -> None:
    n = 0
    for name in ("tiny", "multi", "ecoli_frag", "debruijn4"):
        path = os.path.join(REPO, "tests", "data", f"{name}.fa")
        for k, extra in ORACLE_RUNS:
            zeros, canonical = "-z" in extra, "--canonical" in extra
            out = os.path.join(tmp, f"{name}_{k}_{'_'.join(extra)}.tsv")
            run_cli(["count", "-i", path, "-k", str(k), "--device", "cuda",
                     "-o", out] + extra)
            lines = spectrum_lines(
                count_fasta_file(path, k, canonical=canonical), k,
                zeros=zeros, canonical=canonical)
            want = "".join(ln + "\n" for ln in lines).encode()
            with open(out, "rb") as f:
                if f.read() != want:
                    raise AssertionError(
                        f"{name}.fa k={k} {extra}: differs from oracle"
                    )
            n += 1
    say("oracle", files=n, identical=True,
        runs=[[k] + extra for k, extra in ORACLE_RUNS])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also time the FASTA reader alone and profile the "
                         "device step by kernel")
    args = ap.parse_args()

    smi = phase_environment()
    phase_build()
    max_err = phase_kernel(args.seed)
    timing = phase_timing(args.seed)
    sort_err = phase_rowsort_vs_plain(args.seed)
    sort_timing = phase_rowsort_timing(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fasta = phase_genome(tmp, args.seed)
        launches, runs = phase_main_path(fasta, tmp, args.profile)
        sort_launches, sparse_runs = phase_sparse_main_path(tmp, fasta)
        phase_sparse_device_step(fasta)
        phase_oracle(tmp)
    t8 = timing[f"k8_valid{TIMED_VALID[-1]}"]
    raw21 = sort_timing["raw_k21"]
    print(json.dumps({"kernels": [{
        "name": "histogram_cuda",
        "route": "cuda",
        "source": "findkmer_torch/csrc/histogram.cu",
        "replaces": "findkmer_tpu/ops/pallas/histogram_kernel.py:125",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t8["kernel"]["ms"],
        "plain_ms": t8["plain"]["ms"],
        "plain": "index_add_ scatter histogram, no host sync",
        "shape": list(PROD_SHAPE),
        "k": 8,
        "valid_share": TIMED_VALID[-1],
        "by_case": {case: {name: t["ms"] for name, t in v.items()}
                    for case, v in timing.items()},
        "card": smi,
    }, {
        "name": "sort_rows_cuda",
        "route": "cuda",
        "source": "findkmer_torch/csrc/rowsort.cu",
        "replaces": "bench/probe_plsort.py:43",
        "launches": sort_launches,
        "max_abs_err": sort_err,
        "ms": raw21["kernel"]["ms"],
        "plain_ms": raw21["plain"]["ms"],
        "plain": "torch.sort along the rows + gather of the counts",
        "shape": raw21["shape"],
        "by_shape": {name: {"shape": t["shape"], "ms": t["kernel"]["ms"],
                            "plain_ms": t["plain"]["ms"]}
                     for name, t in sort_timing.items()},
        "sparse_bases_per_s": {
            f"k{r['k']}{''.join(r['args'])}": r["bases_per_s"]
            for r in sparse_runs if r["row_sort"] == "auto"},
        "card": smi,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
