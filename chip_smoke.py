"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--seed N] [--profile] [--only rowsort|window]

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
     {1, 4, 6, 7, 8, 9, 10}, both of the kernel's histograms (block-
     private bins in shared memory and global atomics) where k <= 9, and
     adding into a filled table in place; random codes (~80% valid), one
     hot code, all invalid; shapes (3, 1000) and the production
     (1024, 65536).  Then timing at the production shape, random codes
     80% and 98% valid, k in {4, 6, 7, 8, 9, 10}: median CUDA-event times
     of the kernel (both histograms for k <= 9), of the plain scatter
     histogram (`index_add_`
     into a trash bin, no host sync: the `plain_ms` baseline, at 98%
     valid), of that one `index_add_` call alone on indices prepared
     beforehand (`library_ms`) and of the twin (`bincount(codes[valid])`,
     whose boolean mask syncs with the host)
  4. K2 (fused window histogram) vs `fused_window_histogram_reference` on
     the card, exact, through both entries (uint8 rows, and the 2-bit
     wire packed on the card as the host packer lays it out): k in
     {1, 2, 4, 5, 6, 7, 8, 9, 10}, canonical and not; random rows with
     ~2% invalid bytes (INVALID and 5..255), all invalid, poly-A (one hot
     bin), and rows of exactly k bases; shapes (3, 1000 + k - 1),
     (5, 1003) (a row length that is no multiple of 8) and the
     production (1024, 65536 + k - 1); every case also by the bins the
     wrapper would not pick for its size, and adding into a filled int32
     table in place.  Then the median CUDA-event ms at the production
     shape, 98% of the windows valid (a genome batch's share), k in
     {4, 6, 7, 8, 9, 10}, timed in turn: K2 from the wire, K2 from rows,
     K2 from the wire on global bins (k = 7..9), the two-stage path
     (unpack, plain extraction, K1) and the plain version (unpack,
     extraction, the sync-free `index_add_` scatter: `plain_ms`), and at
     k = 8 K2 on a poly-A batch (one hot bin) and on an all-invalid one.
     Then K2 with private and with global bins on both sides of the
     wrappers' choice between them (1, 16, 64, 256 production rows at
     k = 7, 8, 9; one record of 5000 bases at k = 8), and the card's rate
     of integer atomic adds to random words of a 4^k-bin table (k = 6, 8,
     10) in shared memory and in the L2 (`csrc/atomic_rate.cu`): what one
     atomic a window costs, beside the byte bound
  5. K3 (row sort) vs `sort_rows_reference` (torch.sort + gather) on the
     card, exact: keys equal, (key, count) pairs equal as multisets per
     row; cases random, all equal, all sentinel, sorted, reversed, and
     random keys with many duplicates under distinct payloads; shapes
     (3, 1000) and (64, 64) and 37 rows of every row length at a seam of
     the kernel (1, 2, 7, 8, 9, 255, 256, 257, 1023, 1025, 2047, 2049,
     4096 and 4097, one past the tile) in every key/payload dtype, the
     production row sorts of a 256 Mbase count ((262144, 1024) int64
     keys, (262144, 2048) int64 keys + int32 counts, (262144, 1024) int32
     keys) and one (1, 2^22) row, which takes the kernel's global passes.
     Then the median CUDA-event ms of the kernel and of the library call
     (`torch.sort`, plus a gather where there is a payload: also the plain
     version) at the production shapes, timed in turn (the kernel sorts
     in place, so each of its runs restores the input first; that copy is
     timed alone and subtracted), beside the bound (each byte of the rows
     read once and written once at 3.35 TB/s, or the network's
     compare-exchanges at the card's 32-bit rate, whichever is larger)
  6. dense main path: a seeded 256 Mbase multi-record FASTA (N runs,
     lowercase, IUPAC codes, poly-A runs) counted by `findkmer_torch.cli
     count` at --batch-rows 1024 on cuda for k=8, k=8 --canonical and
     k=10, each by three routes: the default step (K2, which must launch
     once per batch, and K1 never), the two-stage step (dense_kernel=
     "two_stage": K1 once per batch, K2 never) and `--hist scatter`, each
     route twice in mirrored order (a b c c b a); all six outputs must be
     equal byte for byte.  Beside it the rate of
     the host batcher alone and the ms of the device step alone on a
     batch staged on the card, for each of the three (with the share of
     its windows that are valid)
  7. sparse main path: the same genome at k=21 --canonical and k=15
     (row sort K3), each also run with the plain row sort; every row sort
     of every compaction must be a K3 launch, and the two outputs must
     hash equal (streamed sha256; each file is deleted once hashed).
     Prints bases/s and the CLI's phases, with the row sorts' device ms
  8. sparse device step: a staged k=21 --canonical batch: ingest ms,
     four compactions of the repeated batch at sparse_compact_entries =
     2^26 (raw, count-carrying, and one that squeezes first), each with
     its row sorts' device ms, then finalize ms
  9. oracle: tests/data fixtures at k=4, k=8, k=4 -z, k=11, k=21
     --canonical and k=31, byte-identical to oracle/scalar.py
 10. entry points: `selftest --device cuda` (3/3 cases bit-exact);
     `count --per-record` of a seeded FASTA of 2000 records of 100-5000
     bases with N runs at k=8 and k=21 --canonical, equal byte for byte to
     the same run with --device cpu; `count --per-input` over three
     inputs, each file equal to a single `count` of that input

With --profile, two more phases follow the dense main path: the FASTA
reader alone over the genome (no encode, no pack), and torch.profiler
over four steps of a staged k=8 batch on the kernel path, with the
device time of each kernel summed by name and the share of the steps'
wall time the device was busy.

With --only rowsort the script runs phases 1, 2 and 5 (and first prints
what `nvcc -Xptxas -v` says of the row sort's registers and spills, and
the instructions of its production kernels by opcode); with --only window
phases 1 to 4 (with the same of histogram.cu and window_histogram.cu):
the quick check of an edit to those kernels.  Either prints no summary
and no ok-line.

The line before the last is a JSON summary of the kernels (for each its
launches on the main paths, its ms beside the plain version's, the one
library call's where there is one, and its bound); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
    private_bins,
)
from findkmer_torch.ops.cuda.rowsort_kernel import (
    sort_rows_cuda,
    sort_rows_reference,
)
from findkmer_torch.ops.cuda.window_histogram_kernel import (
    add_window_counts_cuda,
    fused_window_histogram_cuda,
    fused_window_histogram_packed_cuda,
    fused_window_histogram_packed_reference,
    fused_window_histogram_reference,
)
from oracle.scalar import count_fasta_file, spectrum_lines

REPO = os.path.dirname(os.path.abspath(__file__))
PROD_SHAPE = (1024, 65536)
GENOME_BASES = 256 << 20
KERNEL_KS = (1, 4, 6, 7, 8, 9, 10)
TIMED_KS = (4, 6, 7, 8, 9, 10)
# the check's share, and about that of a genome batch (N runs, IUPAC
# codes, record separators; the device_step line reports the real one)
TIMED_VALID = (0.8, 0.98)
STEP_KS = (8, 10)
K2_KS = (1, 2, 4, 5, 6, 7, 8, 9, 10)
K2_CASES = ("random", "invalid", "poly_a")
# rows of 65536 + k - 1 bases on both sides of the wrappers' choice between
# block-private and global bins, and one record of 5000 bases
THRESHOLD_ROWS = (1, 16, 64, 256)
RECORD_BASES = 5000
# table sizes of the atomic-rate yardstick
ATOMIC_KS = (6, 8, 10)
# the dense step's three routes: (name, --hist, dense_kernel)
DENSE_ROUTES = (("fused", "auto", "fused"),
                ("two_stage", "auto", "two_stage"),
                ("scatter", "scatter", "fused"))
PER_RECORD_RUNS = ((8, []), (21, ["--canonical"]))
PER_RECORD_GEOM = ["--chunk-len", "8192"]  # a row holds any one record
# the row sorts of a 256 Mbase sparse count at 1024 x 65536 batches: the
# raw compaction (k=21, k=15) and the count-carrying one (k=21)
SORT_SHAPES = (
    ("raw_k21", (262144, 1024), torch.int64, None),
    ("counted_k21", (262144, 2048), torch.int64, torch.int32),
    ("raw_k15", (262144, 1024), torch.int32, None),
)
SORT_CASES = ("random", "equal", "sentinel", "sorted", "reversed")
# row lengths at the seams of K3: a thread's 8 slots, a warp's 256, the
# production rows' 1024 and 2048, the tile of 4096 and one past it
SORT_SEAMS = (1, 2, 7, 8, 9, 255, 256, 257, 1023, 1025, 2047, 2049, 4096,
              4097)
SEAM_ROWS = 37
# the card's published peaks (H100 SXM): device memory, and 32-bit
# operations outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
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


def phase_ptxas(name: str) -> None:
    """What `nvcc -Xptxas -v` says of one source's kernels: registers,
    spills, shared memory (a second compile of that source, to no file)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         "-o", os.devnull, str(_build.CSRC / name)],
        capture_output=True, text=True, check=True)
    lines = res.stderr.splitlines()
    registers, entry = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "Used" in ln and entry:
            registers[entry] = int(ln.split("Used ")[1].split(" registers")[0])
    spills = [ln.strip() for ln in lines
              if "spill" in ln and "0 bytes spill stores, 0 bytes" not in ln]
    say("ptxas", source=name, seconds=time.perf_counter() - t0,
        kernels=len(registers), registers=registers, spills=spills)


# the row sort's instantiations at SORT_SHAPES, by a piece of their mangled
# names: key type, payload type, log2 of the tile
SORT_SASS = {"raw_k21": "sort_tilesIlNS_5NoValELi10ELb0",
             "counted_k21": "sort_tilesIliLi11ELb0",
             "raw_k15": "sort_tilesIiNS_5NoValELi10ELb0"}


# K2's kernels by a piece of their mangled names: source of bases, bins,
# canonical.  A thread runs the body once for each run of 64 bases.
WINDOW_SASS = {
    "wire_word": "window_histINS_12PackedSourceENS_8WordBinsELb0",
    "wire_word_canonical": "window_histINS_12PackedSourceENS_8WordBinsELb1",
    "wire_half": "window_histINS_12PackedSourceENS_8HalfBinsELb0",
    "wire_global": "window_histINS_12PackedSourceENS_10GlobalBinsELb0",
    "rows_word": "window_histINS_10RowsSourceENS_8WordBinsELb0",
}


def phase_sass(source: str = "rowsort.cu", wanted: dict = SORT_SASS) -> None:
    """Instructions of `wanted` kernels in the built library, counted by
    opcode from `cuobjdump -sass`: how many go to the integer pipe
    (compares, selects, shifts, logic), how many are shuffles or atomics.
    The row sort's kernels are straight-line code, so the count is what a
    thread executes; K2's are one pass of the loop over a thread's runs of
    64 bases."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    res = subprocess.run([str(cuobjdump), "-sass", str(_build.build())],
                         capture_output=True, text=True, check=True)
    counts = {}
    for body in res.stdout.split("Function : ")[1:]:
        name = body.split("\n", 1)[0]
        shape = next((k for k, v in wanted.items() if v in name), None)
        if shape is None:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                body))
        counts[shape] = {"total": sum(ops.values()),
                         **dict(ops.most_common(12))}
    if set(counts) != set(wanted):
        raise AssertionError(f"sass: found only {sorted(counts)}")
    say("sass", source=source, per_thread=counts)


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
                # the kernel adds into a table it is given
                table = torch.full_like(want, 7)
                got = histogram_cuda(codes, valid, k, out=table)
                if got is not table:
                    raise AssertionError("histogram_cuda(out=) made a copy")
                max_err = max(max_err, _check_equal(
                    got, want + 7, f"kernel (out=) != twin + table at k={k} "
                    f"shape={shape} case={name}"))
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
            # the one library call that bins: index_add_ alone, the invalid
            # windows already sent to the trash bin, the table zeroed
            idx = torch.where(valid, codes, table_size).reshape(-1).long()
            ones = torch.ones(idx.numel(), dtype=torch.int32, device=dev)
            bins = torch.zeros(table_size + 1, dtype=torch.int32, device=dev)
            _check_equal(bins.index_add_(0, idx, ones)[:table_size], want,
                         f"index_add_ != twin at k={k} valid={share}")
            fns = {
                "plain": lambda: hist_ops.histogram(codes, valid, table_size),
                "library": lambda: bins.index_add_(0, idx, ones),
                "kernel": lambda: histogram_cuda(codes, valid, k),
                "twin": lambda: histogram_reference(codes, valid, k),
            }
            if k <= SHARED_MAX_K:
                fns["kernel_global"] = lambda: histogram_cuda(
                    codes, valid, k, shared=False)
                _check_equal(fns["kernel_global"](), want,
                             f"global kernel != twin at k={k} valid={share}")
            timing[f"k{k}_valid{share}"] = {
                **_time_alternating(fns),
                # codes and the validity mask in, the table out; one add
                # per valid window
                "bound": _bound(codes.numel() * 5 + table_size * 4,
                                float(valid.sum()))}
            del codes, valid, idx, ones, bins
    say("kernel_timing", shape=list(PROD_SHAPE), timing=timing)
    return timing


def _k2_rows(case: str, shape, gen: torch.Generator,
             invalid: float = 0.02) -> torch.Tensor:
    """(B, R) uint8 rows on the card: random bases with a share `invalid`
    of invalid bytes (INVALID and any byte up to 255), all invalid, or
    poly-A."""
    dev = torch.device("cuda")
    u8 = torch.uint8
    if case == "random":
        rows = torch.randint(0, 4, shape, generator=gen, device=dev, dtype=u8)
        junk = torch.randint(4, 256, shape, generator=gen, device=dev,
                             dtype=u8)
        bad = torch.rand(shape, generator=gen, device=dev) < invalid
        return torch.where(bad, junk, rows)
    if case == "invalid":
        return torch.randint(4, 256, shape, generator=gen, device=dev,
                             dtype=u8)
    if case == "poly_a":
        return torch.zeros(shape, dtype=u8, device=dev)
    raise ValueError(case)


def _pack_wire(rows: torch.Tensor) -> tuple:
    """(B, R) uint8 rows -> the 2-bit wire as the host packer lays it out
    (`_numpy_pack_rows`): packed (B, R8/4), 4 bases a byte, and
    validbits (B, R8/8), MSB first; slots past R are invalid."""
    B, R = rows.shape
    R8 = (R + 7) // 8 * 8
    padded = torch.full((B, R8), window_ops.INVALID, dtype=torch.uint8,
                        device=rows.device)
    padded[:, :R] = rows
    valid = (padded < 4).to(torch.uint8)
    safe = padded * valid
    packed = ((safe[:, 0::4] << 6) | (safe[:, 1::4] << 4)
              | (safe[:, 2::4] << 2) | safe[:, 3::4])
    bits = valid[:, 0::8] << 7
    for j in range(1, 8):
        bits |= valid[:, j::8] << (7 - j)
    return packed.contiguous(), bits.contiguous()


def phase_window_kernel(seed: int) -> int:
    """K2 vs its plain version, exact, through both entries, at every k,
    canonical and not, case and shape -> max abs err."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    max_err = 0
    n_cases = 0
    for k in K2_KS:
        shapes = [(3, 1000 + k - 1), (5, 1003),
                  (PROD_SHAPE[0], PROD_SHAPE[1] + k - 1)]
        cases = [(c, sh) for sh in shapes for c in K2_CASES]
        cases.append(("exact_k", (3, k)))
        for case, shape in cases:
            rows = _k2_rows("random" if case == "exact_k" else case, shape,
                            gen)
            if case == "exact_k":
                rows &= 3  # all valid: one window a row
            packed, validbits = _pack_wire(rows)
            R = shape[1]
            for canonical in (False, True):
                want = fused_window_histogram_reference(rows, k, canonical)
                what = f"k={k} canonical={canonical} shape={shape} {case}"
                _check_equal(fused_window_histogram_packed_reference(
                    packed, validbits, k, canonical, R), want,
                    f"wire packing: {what}")
                max_err = max(max_err, _check_equal(
                    fused_window_histogram_cuda(rows, k, canonical), want,
                    f"K2 (rows) != plain at {what}"))
                max_err = max(max_err, _check_equal(
                    fused_window_histogram_packed_cuda(
                        packed, validbits, k, canonical, R), want,
                    f"K2 (wire) != plain at {what}"))
                n_cases += 2
                # the bins the wrapper did not choose for this size
                other = not private_bins(k, shape[0] * (R - k + 1))
                if not other or k <= SHARED_MAX_K:
                    _check_equal(fused_window_histogram_cuda(
                        rows, k, canonical, private=other), want,
                        f"K2 (rows, private={other}) != plain at {what}")
                    _check_equal(fused_window_histogram_packed_cuda(
                        packed, validbits, k, canonical, R, private=other),
                        want, f"K2 (wire, private={other}) != plain at {what}")
                # the kernel adds into an int32 table it is given
                for batch in (rows, (packed, validbits)):
                    table = torch.full_like(want, 7)
                    _check_equal(add_window_counts_cuda(
                        batch, table, k, canonical, R), want + 7,
                        f"K2 into a table != plain + table at {what}")
            del rows, packed, validbits
        torch.cuda.empty_cache()
    say("window_kernel_vs_plain", cases=n_cases, max_abs_err=max_err)
    return max_err


def phase_window_timing(seed: int) -> dict:
    """Median CUDA-event ms at the production shape for k in TIMED_KS,
    with invalid bytes spread so that a genome batch's share of the
    windows (TIMED_VALID[-1]) is valid, timed in turn: K2 from the wire
    ("kernel") and from rows, the two-stage step (unpack, plain
    extraction, K1) and the plain version (unpack, extraction,
    `index_add_` scatter, whose trash bin takes every invalid window: no
    host sync)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    timing = {}
    shares = {}
    for k in TIMED_KS:
        shape = (PROD_SHAPE[0], PROD_SHAPE[1] + k - 1)
        R = shape[1]
        rows = _k2_rows("random", shape, gen,
                        invalid=1 - TIMED_VALID[-1] ** (1 / k))
        packed, validbits = _pack_wire(rows)
        valid_share = float(window_ops.window_codes(rows, k)[1]
                            .float().mean())

        def extract():
            return window_ops.window_codes(
                window_ops.unpack_rows(packed, validbits, R), k)

        fns = {
            "plain": lambda: hist_ops.histogram(*extract(), 4 ** k),
            "kernel": lambda: fused_window_histogram_packed_cuda(
                packed, validbits, k, False, R),
            "kernel_rows": lambda: fused_window_histogram_cuda(rows, k),
            "two_stage": lambda: histogram_cuda(*extract(), k),
        }
        if SHARED_MAX_K >= k > 6:  # the new loads on the old binning
            fns["kernel_global"] = lambda: fused_window_histogram_packed_cuda(
                packed, validbits, k, False, R, private=False)
        want = fused_window_histogram_reference(rows, k)
        for name, fn in fns.items():
            _check_equal(fn(), want, f"{name} != plain version at k={k}")
        if k == 8:  # a hot bin, and no window at all
            wires = {case: _pack_wire(_k2_rows(case, shape, gen))
                     for case in ("poly_a", "invalid")}
            for case, (p, v) in wires.items():
                fns[f"kernel_{case}"] = (
                    lambda p=p, v=v: fused_window_histogram_packed_cuda(
                        p, v, k, False, R))
        timing[f"k{k}"] = {
            **_time_alternating(fns),
            # the wire in, the table out; one add per valid window
            "bound": _bound(packed.numel() + validbits.numel() + 4 ** k * 4,
                            valid_share * shape[0] * PROD_SHAPE[1])}
        shares[f"k{k}"] = valid_share
        del rows, packed, validbits
        torch.cuda.empty_cache()
    say("window_kernel_timing", shape=[PROD_SHAPE[0], "65536+k-1"],
        valid_share=shares, timing=timing)
    return timing


def phase_window_threshold(seed: int) -> None:
    """K2 from the wire with block-private and with global bins, timed in
    turn on both sides of the wrappers' choice (`private_bins`): batches
    of THRESHOLD_ROWS production rows at k = 7, 8, 9, and one record of
    RECORD_BASES bases at k = 8."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    lines = []
    shapes = [(k, (n, PROD_SHAPE[1] + k - 1))
              for k in (7, 8, 9) if k <= SHARED_MAX_K for n in THRESHOLD_ROWS]
    shapes.append((8, (1, RECORD_BASES)))
    for k, shape in shapes:
        R = shape[1]
        rows = _k2_rows("random", shape, gen)
        packed, validbits = _pack_wire(rows)
        want = fused_window_histogram_reference(rows, k)
        fns = {
            name: (lambda private=private: fused_window_histogram_packed_cuda(
                packed, validbits, k, False, R, private=private))
            for name, private in (("private", True), ("global", False))
        }
        for name, fn in fns.items():
            _check_equal(fn(), want, f"{name} bins != plain at k={k} {shape}")
        windows = shape[0] * (R - k + 1)
        t = _time_alternating(fns)
        lines.append({"k": k, "shape": list(shape), "windows": windows,
                      "windows_per_bin": windows / 4 ** k,
                      "wrapper_takes": "private" if private_bins(k, windows)
                      else "global",
                      **{name: v["ms"] for name, v in t.items()}})
        del rows, packed, validbits
    say("window_kernel_threshold", cases=lines)


def phase_atomic_rate() -> dict:
    """The card's rate of integer atomic adds to random words, beside the
    histogram kernels' times: a table of 4^k bins for k in ATOMIC_KS, in
    shared memory (int32 words at k = 6, 16-bit halves of 32768 words at
    k = 8 as the kernels lay them out; 4^10 bins fit no SM) and in the
    global table behind the L2.  G adds a second, and the ms that one add
    for each window of a production batch would take at that rate."""
    lib = _build.load()
    dev = torch.device("cuda")
    per_thread = 256
    rates = {}
    for k in ATOMIC_KS:
        for where in ("shared", "l2"):
            half = where == "shared" and k == 8
            words = 4 ** k // 2 if half else 4 ** k
            if where == "shared" and words * 4 > 227 * 1024:
                rates[f"k{k}_{where}"] = None
                continue
            table = torch.zeros(words, dtype=torch.int32, device=dev)
            threads = ctypes.c_int64(0)
            # as many blocks as the histogram kernels run an SM
            per_sm = 8 if where == "l2" or k <= 6 else 1

            def run():
                err = lib.fk_atomic_rate(
                    table.data_ptr(), words, int(where == "shared"),
                    int(half), per_sm, per_thread, ctypes.byref(threads),
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(
                        "atomic rate launch failed: CUDA error "
                        f"{err} ({lib.fk_cuda_error_string(err).decode()})")

            ms = _median_ms(run)
            adds = threads.value * per_thread
            if where == "l2" and int(table.sum()) % adds:
                raise AssertionError("atomic rate: adds were lost")
            rates[f"k{k}_{where}"] = {
                "adds": adds, "ms": ms, "g_adds_per_s": adds / ms / 1e6,
                "batch_ms": PROD_SHAPE[0] * PROD_SHAPE[1] / (adds / ms)}
    say("atomic_rate", rates=rates)
    return rates


def _bound(nbytes: float, ops: float) -> dict:
    """The least ms the card could take: `nbytes` moved at its memory rate
    or `ops` done at its 32-bit rate, whichever takes longer."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": ops}


def _sort_input(shape, kd, case, gen: torch.Generator) -> torch.Tensor:
    dev = torch.device("cuda")
    G, C = shape
    if case == "duplicates":
        return torch.randint(0, 50, shape, generator=gen, device=dev,
                             dtype=kd)
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
    combos += [((SEAM_ROWS, C), kd, vd) for C in SORT_SEAMS
               for kd in dts for vd in (None,) + dts]
    combos += [(shape, kd, vd) for _, shape, kd, vd in SORT_SHAPES]
    combos.append(((1, 1 << 22), torch.int64, torch.int32))
    n_cases = 0
    for shape, kd, vd in combos:
        for case in SORT_CASES + ("duplicates",):
            keys = _sort_input(shape, kd, case, gen)
            if vd is None:
                vals = None
            elif case == "duplicates":  # a distinct payload in every slot
                vals = torch.arange(keys.numel(), device="cuda",
                                    dtype=vd).reshape(shape)
            else:
                vals = torch.randint(0, 1 << 30, shape, generator=gen,
                                     device="cuda", dtype=vd)
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
    """Median CUDA-event ms of K3 and of the library call (`torch.sort`,
    plus a gather of the payload: the plain version too) at the production
    row-sort shapes, random codes, timed in turn.  The kernel sorts in
    place: each of its runs first restores the unsorted input (`copy`,
    timed alone too); its ms is kernel+copy minus copy.  The bound counts
    keys and payload read once and written once, and the network's
    compare-exchanges (P/2 a stage, log2(P) (log2(P) + 1) / 2 stages for
    rows of P = next_pow2(C) slots)."""
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
        slot = src.element_size() + (vsrc.element_size() if vd else 0)
        log_p = (shape[1] - 1).bit_length()
        bound = _bound(2 * src.numel() * slot,
                       shape[0] * (1 << log_p >> 1) * log_p * (log_p + 1) / 2)
        timing[name] = {"shape": list(shape), "keys": str(kd),
                        "vals": str(vd), **t,
                        "library_ms": t["plain"]["ms"], **bound,
                        "share_of_bound": bound["bound_ms"] / t["kernel"]["ms"]}
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


def _read_and_delete(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    os.unlink(path)
    return data


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
        fused_window_histogram_cuda.launches = 0
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
        if histogram_cuda.launches or fused_window_histogram_cuda.launches:
            raise AssertionError("the sparse path launched a histogram")
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
    for each route of DENSE_ROUTES."""
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
        for route, hist, dense_kernel in DENSE_ROUTES:
            kcfg = cfg.replace(k=k, hist=hist)
            counter = KmerCounter(kcfg, torch.device("cuda"),
                                  dense_kernel=dense_kernel)
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
            say("device_step", k=k, route=route, steps=steps,
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


def run_cli(args, row_sort: str = "auto",
            dense_kernel: str = "fused") -> tuple:
    """findkmer_torch.cli.main(args) in this process -> (stats, wall_s)."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(args, row_sort=row_sort, dense_kernel=dense_kernel)
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
    fused_window_histogram_cuda.launches = 0
    sort_rows_cuda.launches = 0
    for k, extra in ((8, []), (8, ["--canonical"]), (10, [])):
        want_bytes = None
        # each route twice, in mirrored order (a b c c b a), so that a
        # drift over the calls does not favour one route's rate
        order = list(DENSE_ROUTES) + list(reversed(DENSE_ROUTES))
        for i, (route, hist, dense_kernel) in enumerate(order):
            out = os.path.join(tmp, f"k{k}{''.join(extra)}_{route}.tsv")
            k1 = histogram_cuda.launches
            k2 = fused_window_histogram_cuda.launches
            stats, wall = run_cli(
                ["count", "-i", fasta, "-k", str(k), "--batch-rows", "1024",
                 "--chunk-len", "65536", "--device", "cuda", "--hist", hist,
                 "-o", out, "--stats", "json"] + extra,
                dense_kernel=dense_kernel,
            )
            k1 = histogram_cuda.launches - k1
            k2 = fused_window_histogram_cuda.launches - k2
            n = stats["batches"]
            want = {"fused": (0, n), "two_stage": (n, 0), "scatter": (0, 0)}
            if (k1, k2) != want[route]:
                raise AssertionError(
                    f"k={k} {extra} {route}: K1 launched {k1} and K2 {k2} "
                    f"times for {n} batches"
                )
            got = _read_and_delete(out)
            if want_bytes is None:
                want_bytes = got  # the first run is K2's
            elif got != want_bytes:
                raise AssertionError(
                    f"k={k} {extra}: the {route} output differs from K2's")
            run = {"k": k, "args": extra, "route": route, "hist": hist,
                   "pass": i // len(DENSE_ROUTES),
                   "batches": n, "k1_launches": k1, "k2_launches": k2,
                   "bases": stats["bases"], "cli_wall_s": stats["wall_s"],
                   "bases_per_s": stats["bases_per_s"], "wall_s": wall,
                   "device": stats["device"]}
            say("main_path", **run)
            runs.append(run)
        say("main_path_identical", k=k, args=extra, runs=len(order),
            bytes=len(want_bytes))
    if sort_rows_cuda.launches:
        raise AssertionError("the dense path launched the row sort")
    return (histogram_cuda.launches, fused_window_histogram_cuda.launches,
            runs)


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


def write_records(path: str, seed: int, n: int = 2000) -> int:
    """A seeded FASTA of n records of 100-5000 bases: uniform ACGT with
    ~5% lowercase, an N run of 1-300 bases in about a third of them.
    -> bases written."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    total = 0
    with open(path, "wb") as f:
        for r in range(n):
            ln = int(rng.integers(100, 5001))
            seq = acgt[rng.integers(0, 4, ln, dtype=np.uint8)]
            seq[rng.integers(0, 20, ln, dtype=np.uint8) == 0] |= 0x20
            if rng.random() < 0.33:
                run = int(rng.integers(1, 301))
                s = int(rng.integers(0, ln))
                seq[s : s + run] = ord("N")
            lines = [seq[i : i + 80].tobytes() for i in range(0, ln, 80)]
            f.write(f">rec{r} seeded\n".encode() + b"\n".join(lines) + b"\n")
            total += ln
    return total


def phase_entry_points(tmp: str, seed: int) -> dict:
    """selftest on the card; count --per-record on the card against the
    CPU; count --per-input against single counts.  -> K2 launches of the
    runs on the card."""
    fused_window_histogram_cuda.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["selftest", "--device", "cuda", "--seed", str(seed)])
    if rc != 0 or "selftest OK (3/3 cases bit-exact)" not in out.getvalue():
        raise AssertionError(
            f"selftest exited {rc}: {out.getvalue()} {err.getvalue()}")
    say("selftest", seconds=time.perf_counter() - t0,
        lines=out.getvalue().strip().splitlines())

    records = os.path.join(tmp, "records.fa")
    bases = write_records(records, seed + 7)
    for k, extra in PER_RECORD_RUNS:
        got = {}
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"per_record_{dev}.txt")
            k2 = fused_window_histogram_cuda.launches
            stats, wall = run_cli(
                ["count", "-i", records, "-k", str(k), "--per-record",
                 "--device", dev, "-o", path, "--stats", "json"]
                + PER_RECORD_GEOM + extra)
            got[dev] = _read_and_delete(path)
            say("per_record", k=k, args=extra, device=dev,
                records=stats["records"], bases=bases, wall_s=wall,
                records_per_s=stats["records"] / wall,
                k2_launches=fused_window_histogram_cuda.launches - k2,
                out_bytes=len(got[dev]))
        if got["cuda"] != got["cpu"] or got["cuda"].count(b">") != 2000:
            raise AssertionError(
                f"--per-record k={k} {extra}: the card's output differs "
                "from the CPU's")

    inputs = [records]
    for i in (1, 2):
        inputs.append(os.path.join(tmp, f"input{i}.fa"))
        write_genome(inputs[-1], seed + 7 + i, total=8 << 20)
    for k, extra in PER_RECORD_RUNS:
        d = os.path.join(tmp, f"per_input_k{k}")
        run_cli(["count", "-i", *inputs, "-k", str(k), "--per-input", "-o",
                 d, "--device", "cuda"] + extra)
        for p in inputs:
            one = os.path.join(tmp, "one.tsv")
            run_cli(["count", "-i", p, "-k", str(k), "-o", one, "--device",
                     "cuda"] + extra)
            stem = os.path.splitext(os.path.basename(p))[0]
            if _read_and_delete(os.path.join(d, f"{stem}.tsv")) != \
                    _read_and_delete(one):
                raise AssertionError(
                    f"--per-input k={k} {extra}: {stem}.tsv differs from a "
                    "single count of its input")
        say("per_input", k=k, args=extra, inputs=len(inputs),
            identical=True)
    return fused_window_histogram_cuda.launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also time the FASTA reader alone and profile the "
                         "device step by kernel")
    ap.add_argument("--only", choices=["rowsort", "window"],
                    help="run only the row sort's phases (K3), or only the "
                         "histogram kernels' (K1 and K2), and stop: no "
                         "summary, no ok-line; the quick check of an edit")
    args = ap.parse_args()

    smi = phase_environment()
    phase_build()
    if args.only == "rowsort":
        phase_ptxas("rowsort.cu")
        phase_sass()
        phase_rowsort_vs_plain(args.seed)
        phase_rowsort_timing(args.seed)
        return 0
    if args.only == "window":
        phase_ptxas("histogram.cu")
        phase_ptxas("window_histogram.cu")
        phase_sass("window_histogram.cu", WINDOW_SASS)
    max_err = phase_kernel(args.seed)
    timing = phase_timing(args.seed)
    k2_err = phase_window_kernel(args.seed)
    k2_timing = phase_window_timing(args.seed)
    phase_window_threshold(args.seed)
    atomic_rates = phase_atomic_rate()
    if args.only == "window":
        return 0
    sort_err = phase_rowsort_vs_plain(args.seed)
    sort_timing = phase_rowsort_timing(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fasta = phase_genome(tmp, args.seed)
        launches, k2_launches, runs = phase_main_path(fasta, tmp,
                                                      args.profile)
        sort_launches, sparse_runs = phase_sparse_main_path(tmp, fasta)
        phase_sparse_device_step(fasta)
        phase_oracle(tmp)
        os.unlink(fasta)
        phase_entry_points(tmp, args.seed)
    t8 = timing[f"k8_valid{TIMED_VALID[-1]}"]
    w8 = k2_timing["k8"]
    raw21 = sort_timing["raw_k21"]

    def ms_of(case: dict) -> dict:
        return {name: t["ms"] for name, t in case.items() if "ms" in t}

    def bound_of(b: dict) -> dict:
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}

    print(json.dumps({"kernels": [{
        "name": "histogram_cuda",
        "route": "cuda",
        "source": "findkmer_torch/csrc/histogram.cu",
        "replaces": "findkmer_tpu/ops/pallas/histogram_kernel.py:125",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t8["kernel"]["ms"],
        "plain_ms": t8["plain"]["ms"],
        **bound_of(t8["bound"]),
        "library_ms": t8["library"]["ms"],
        "plain": "index_add_ scatter histogram, no host sync",
        "library": "index_add_ alone, indices prepared beforehand",
        "shape": list(PROD_SHAPE),
        "k": 8,
        "valid_share": TIMED_VALID[-1],
        "by_case": {case: {**ms_of(v), **bound_of(v["bound"])}
                    for case, v in timing.items()},
        "card": smi,
    }, {
        "name": "fused_window_histogram_cuda",
        "route": "cuda",
        "source": "findkmer_torch/csrc/window_histogram.cu",
        "replaces": "findkmer_tpu/ops/pallas/histogram_kernel.py:254",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": w8["kernel"]["ms"],
        "plain_ms": w8["plain"]["ms"],
        **bound_of(w8["bound"]),
        "library_ms": None,
        "plain": "unpack, plain-torch window extraction, index_add_ "
                 "scatter histogram, no host sync",
        "shape": [PROD_SHAPE[0], PROD_SHAPE[1] + 7],
        "k": 8,
        "by_k": {k: {**ms_of(v), **bound_of(v["bound"])}
                 for k, v in k2_timing.items()},
        "atomic_rate": atomic_rates,
        "dense_bases_per_s": {
            f"k{r['k']}{''.join(r['args'])}_{r['route']}_{r['pass']}":
            r["bases_per_s"] for r in runs},
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
        **bound_of(raw21),
        "library_ms": raw21["library_ms"],
        "plain": "torch.sort along the rows + gather of the counts",
        "library": "the same torch.sort (+ gather): the plain version is "
                   "the library call",
        "shape": raw21["shape"],
        "by_shape": {name: {"shape": t["shape"], "ms": t["kernel"]["ms"],
                            "plain_ms": t["plain"]["ms"],
                            "library_ms": t["library_ms"],
                            **bound_of(t),
                            "share_of_bound": t["share_of_bound"]}
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
