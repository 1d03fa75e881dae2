"""Smoke run of the PyTorch port on one CUDA card: build, check, drive.

    python3 chip_smoke.py [--seed N] [--profile]
                          [--only rowsort|window|stream|filter|tools|mesh|
                                  spill|installed]
                          [--against DIR]

Run from the root of a checkout, on a machine with a CUDA card (Hopper,
sm_90a) and nvcc.  Each phase prints one JSON line (its `t`: seconds since
the start); any failure raises, so the exit code is non-zero and the
final ok-line is not printed.

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
     4096, and past the tile 4097, 8191, 8192, 8193, 12289 (sorted
     inside shared memory), 16385, 32769 and 2^16 + 3 (one, two and three
     merge passes)) in every key/payload dtype, the production row sorts
     of a 256 Mbase count ((262144, 1024) int64 keys, (262144, 2048)
     int64 keys + int32 counts, (262144, 1024) int32 keys), one (1, 2^22)
     row and one (1, 2^26) row (the dedup before a spill decision of
     phase 11).  Then the median CUDA-event ms of the kernel and of the
     library call (`torch.sort`, plus a gather where there is a payload:
     also the plain version) at the production shapes and at those two
     long rows, timed in turn (the kernel sorts in place, so each of its
     runs restores the input first; that copy is timed alone and
     subtracted), beside the bound (each byte of the rows read once and
     written once at 3.35 TB/s, or the network's compare-exchanges and
     the merges' comparisons at the card's 32-bit rate, whichever is
     larger); for the long rows also the device ms of each stage (the
     spans' sort inside shared memory, each merge pass, the copy home)
     from a torch.profiler trace, the pass count and the pass-count
     bound (passes x the bytes bound), on the `rowsort_timing` line
  6. dense main path: a seeded 256 Mbase multi-record FASTA (N runs,
     lowercase, IUPAC codes, poly-A runs) counted by `findkmer_torch.cli
     count` at --batch-rows 1024 on cuda for k=8, k=8 --canonical and
     k=10, each by three routes: the default step (K2, which must launch
     once per batch, and K1 never), the two-stage step (dense_kernel=
     "two_stage": K1 once per batch, K2 never) and `--hist scatter`; the
     three outputs must be equal byte for byte.  Beside it the rate of
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
     `count --per-record` of a seeded FASTA of 1000 records of 100-5000
     bases with N runs at k=8 and k=21 --canonical, equal byte for byte to
     the same run with --device cpu; `count --per-input` over three
     inputs, each file equal to a single `count` of that input
 11. the restartable stream, over a seeded genome of 64 Mbase of its
     own in batches of 256 x 65536 (five batches, as the main paths'
     genome makes at 1024 rows, at a quarter of the bytes), every output
     held by sha256 to a `count` run of the same flags over it.
     Dense: `stream -k 8 --checkpoint D --checkpoint-every 2` by the
     default step (K2 once a batch) and by the two-stage step (K1 once a
     batch).  Sparse:
     `stream -k 21 --canonical --checkpoint D --checkpoint-every 2`: every
     row sort a K3 launch, four of them for its three checkpoints; the
     file size of each checkpoint, and from `--stats json` the seconds of
     their compactions, copies to the host and compressed writes.  Kill
     and resume: the same sparse stream as a subprocess, SIGKILLed once
     its first `latest.json` exists and run again to the end (with the
     default --checkpoint-every: the final checkpoint alone): same bytes,
     and the `--stats json` totals of the uninterrupted run.  Spill:
     `count -k 21 --canonical --spill S --sparse-capacity 2^23
     --sparse-compact-entries 2^24` writes three runs of ~0.25 GB or more
     and merges them: same bytes, the run files gone, with the seconds of
     each spill, the bytes spilled and the seconds of the residual pull
     and of the merge; then `stream` with both --spill and --checkpoint,
     killed after a checkpoint that follows a spill, and resumed: same
     bytes.  Heap-merge finalize: FINDKMER_ORDERED_FINALIZE=0 `count -k
     21 --canonical`: same bytes, its finalize seconds beside the ordered
     finalize's
 12. read filtering (`filter`, a contaminant screen): a seeded reference
     of 8 Mbase, its spectra counted on the card (k=21 --canonical, k=15,
     k=31), 1,000,000 FASTQ reads of 150 bases (half drawn from the
     reference with 1% substitutions, half from an unrelated seeded
     genome, 0.2% N), the first 50,000 of them as FASTA, 100,000 R1/R2
     pairs of a 400-base insert, and a 50,000-read subset.  Each run by `--engine
     host` and by `--engine device --device cuda`, whose output sha256 and
     kept/seen must equal the host engine's: --canonical (the offsets
     flow, and FINDKMER_FILTER_FAST=0 the list flow), the FASTA reads,
     --paired --pair-mode both --invert, --min-frac 0.5, the subset at
     k=15 and k=31 (at k=31 also with the CLI's defaults, whose auto pick
     on cuda is the device engine); each device run's batch steps must
     have run on cuda, and none of K1-K3 may launch.  Reads/s and bases/s
     of every run; then the device step alone on one staged batch of 256
     x 65536 windows: median CUDA-event ms of the step and of its
     extraction, membership and bitmap, each beside the bytes bound of its
     own inputs and outputs, the member table's bytes, and the spectrum
     load's host seconds by part (parse, fold, the whole load, the host
     engine's prefilter)
 13. the spectrum tools over a cohort (the Mash `sketch`/`dist` and
     kmtricks matrix workload of a small isolate collection): 8 seeded
     samples of 2,000,000 bases, one ancestor with 0.5-5% of its bases
     substituted in each and four N gaps, 16 Mbase in all.  On cuda, in
     this process, each timed (bases/s): `count --per-input -k 21
     --canonical`, `sketch --per-input -k 21 --canonical -s 1000`,
     `histo -k 21 --canonical` and `histo -k 8` (K2) of one sample,
     `count -k 8` and a plain `count -k 21` of it, `count` of the eight as
     one input, `stats`, then `matrix -k 21 --canonical --min-samples 2`
     (its counting and its streaming merge timed apart).  Beside that, in
     three worker processes, the host tools that stream in Python over
     the per-input spectra: `matrix` with the same flags; `expr` "s1 +
     s2", "s1 * s2", "s1 ~ s2" and "s1 - s2"; `diff`, `sort`, `topn` and
     `query`.  Then, alone in this process, those that take the C paths:
     `merge`, `intersect` and `subtract` (both modes) of two samples,
     `info`, `histo --from-spectrum`, `similarity` of two spectra,
     `merge` of the eight, `sketch` of each spectrum, `similarity` over
     the eight sketches (28 pairs), `canonize` of the plain count.  Each
     host tool timed (seconds, input lines/s).  Must hold, by sha256:
     `matrix -k` equals `matrix` over the per-input spectra, each `sketch
     -k` the
     sketch of its spectrum, each recounting `histo` the `histo
     --from-spectrum` of its count (k=21 and k=8), the merge of the eight
     their count as one input, `canonize` of the plain count the
     `--canonical` count, `sort` of a sorted spectrum itself, and the
     `expr` results `merge`, `intersect`, `subtract --mode counters` and
     `--mode kmers`; `info` reads a sorted canonical k=21 spectrum,
     `query` answers each k-mer, `diff` exits 1.  Every row sort of the
     phase is a K3 launch, K2 launches in the two k=8 runs alone, K1 never
 14. counting over a mesh of shards (`findkmer_torch/parallel/`), every
     shard on card 0: the dry run (`parallel/dryrun.py`) over meshes of 2
     and 4 shards on a seeded genome of 128,000,000 bases, two batches
     of 1024 x 65536, each leg's spectrum sha256-equal to the single-device
     counter's on the same batches (counted first): psum and psum_scatter
     at k=8, all_to_all at k=15 on the full 4^15 table (4 GiB of int32
     over the shards) and on a table scaled to 4^8 entries (the full
     table's first counts), dp_sparse at k=21 --canonical, a checkpoint
     written after the first batch at 4 shards and restored at 2 (at 2
     shards: restored on the single engine), and dp_sparse with --spill
     at a capacity of 2^20 (a run per shard at least).  The kernels'
     launches in those mesh runs are counted from 0: K2 in the psum legs,
     K3 once a row sort of the dp_sparse legs, K1 never; each leg's step
     ms by batch beside the single-device step's.  Then on a seeded 32
     Mbase genome: `count --devices 0` (every card; one, so the single
     engine) sha256-equal to `count`, `count --devices 2` refused with the
     reference's "need 2 devices, have 1" on one card (run and compared
     where there are two), `torch.cuda.device_count()`; a 2-process
     `stream --coordinator 127.0.0.1:PORT -k 21 --canonical` group (gloo,
     both processes on this card) whose process 0 output is sha256-equal
     to one process's `count`; and `count -k 8 --profile DIR`, whose
     Chrome trace names K2's kernel (window_hist)
 15. the installed package (run after phase 8, on its genome): a wheel
     built by `pip wheel --no-build-isolation --no-deps --no-index` from a
     copy of this checkout (with $CC, then, if that fails, with cc, as
     the port builds its C encoder), installed by `pip install --target`
     into a temporary directory, and a `python -P` child run from there
     with PYTHONPATH set to that directory alone and FINDKMER_TORCH_CACHE
     set to an empty one: it builds the kernels from the installed
     csrc/ and the C encoder from the installed `_native/encode.c` into
     that cache (seconds of each), then counts the 256 Mbase genome at
     1024 x 65536 on cuda with `count -k 8` (K2 once a batch) and `count
     -k 21 --canonical` (K3 on every row sort), each output sha256-equal
     to the checkout's run of phases 6 and 7, with its kernel launches
     (counted from 0 in the child) equal to theirs, `--stats json`
     naming the card and the C encoder, the package, both libraries and
     the cache under the temporary directories, and nothing of the JAX
     package imported

With --profile, two more phases follow the dense main path: the FASTA
reader alone over the genome (no encode, no pack), and torch.profiler
over four steps of a staged k=8 batch on the kernel path, with the
device time of each kernel summed by name and the share of the steps'
wall time the device was busy.

With --only rowsort the script runs phases 1, 2 and 5 (and first prints
what `nvcc -Xptxas -v` says of the row sort's registers and spills, and
the instructions of its production kernels by opcode); with --only window
phases 1 to 4 (with the same of histogram.cu and window_histogram.cu):
the quick check of an edit to those kernels; with --only stream phases
1, 2 and 11; with --only filter phases 1, 2 and 12; with --only tools
phases 1, 2 and 13; with --only mesh phases 1, 2 and 14; with --only
installed phases 1, 2 and 15 (the checkout's own two counts of the genome
made first, to hold the installed ones to); with --only spill [--against
DIR] phases 1 and 2, then phase 11's `count --spill` as a process of its
own from this checkout and from DIR (another checkout
of the port, such as the parent commit unpacked into build/), in turn,
with each run's wall, dispatch seconds and peak device memory, the
outputs sha256-equal.  Each of the eight prints no summary and no
ok-line.

The line before the last is a JSON summary of the kernels (for each its
launches on the main paths: the `count` runs, each run that phase 11
makes in this process, the filter runs of phase 12, which launch none,
the runs on the card of phase 13, the mesh runs of phase 14 and the
installed package's runs of phase 15 (`launches_by_path`), each counted
from 0, and for K3 apart those on
rows longer than a tile (`long_launches_by_path`: the dedups of the spill
paths, none in a plain `count` or `stream`); its ms beside the plain
version's, the one
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
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from findkmer_torch import Config, cli, filter_device, pipeline
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
    sort_plan,
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
# records of the --per-record runs: k=21 on the card and on the host is
# most of phase 10, so the depth that leaves phase 13 its time
PER_RECORD_RECORDS = 1000
PER_RECORD_GEOM = ["--chunk-len", "8192"]  # a row holds any one record
# the row sorts of a 256 Mbase sparse count at 1024 x 65536 batches: the
# raw compaction (k=21, k=15) and the count-carrying one (k=21)
SORT_SHAPES = (
    ("raw_k21", (262144, 1024), torch.int64, None),
    ("counted_k21", (262144, 2048), torch.int64, torch.int32),
    ("raw_k15", (262144, 1024), torch.int32, None),
)
# one row that takes K3's merge passes (the cross-row dedup's shape)
LONG_ROW = ("long_row", (1, 1 << 22), torch.int64, torch.int32)
# the same at the size of the dedup before a spill decision of `count
# --spill` at 256 Mbase: the whole store as one row
DEDUP_ROW = ("dedup_row", (1, 1 << 26), torch.int64, torch.int32)
SORT_CASES = ("random", "equal", "sentinel", "sorted", "reversed")
# row lengths at the seams of K3: a thread's 8 slots, a warp's 256, the
# production rows' 1024 and 2048, the tile of 4096; past it the sort
# inside shared memory alone (to 12289 at 12 bytes a slot; 8193 and 12289
# take a merge pass at 16), then one merge pass (16385: the copy home), two
# (32769, whose last run is alone) and three (2^16 + 3)
SORT_SEAMS = (1, 2, 7, 8, 9, 255, 256, 257, 1023, 1025, 2047, 2049, 4096,
              4097, 8191, 8192, 8193, 12289, 16385, 32769, (1 << 16) + 3)
SEAM_ROWS = 37
# the card's published peaks (H100 SXM): device memory, and 32-bit
# operations outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
SPARSE_RUNS = ((21, ["--canonical"]), (15, []))
ORACLE_RUNS = ((4, []), (8, []), (4, ["-z"]), (11, []),
               (21, ["--canonical"]), (31, []))


_START = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One JSON line of a phase, with `t`: seconds since the script
    started."""
    print(json.dumps({"phase": phase, **kv,
                      "t": time.perf_counter() - _START}), flush=True)


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
    """What `nvcc -Xptxas -v` says of one source's kernels: registers and
    static shared memory of each, and the bytes of those that spill (a
    second compile of that source, to no file)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         "-o", os.devnull, str(_build.CSRC / name)],
        capture_output=True, text=True, check=True)
    registers, smem, spills, entry = {}, {}, {}, None
    for ln in res.stderr.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif "spill stores" in ln and entry:
            stores, loads = re.findall(r"(\d+) bytes spill", ln)
            if int(stores) or int(loads):
                spills[entry] = {"stores": int(stores), "loads": int(loads)}
        elif "Used" in ln and entry:
            registers[entry] = int(ln.split("Used ")[1].split(" registers")[0])
            m = re.search(r"(\d+) bytes smem", ln)
            smem[entry] = int(m.group(1)) if m else 0
    say("ptxas", source=name, seconds=time.perf_counter() - t0,
        kernels=len(registers), registers=registers, smem=smem,
        spills=spills)


# the row sort's instantiations at SORT_SHAPES, by a piece of their mangled
# names: key type, payload type, log2 of the tile
SORT_SASS = {"raw_k21": "sort_tilesIlNS_5NoValELi10EE",
             "counted_k21": "sort_tilesIliLi11EE",
             "raw_k15": "sort_tilesIiNS_5NoValELi10EE"}


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
    combos += [LONG_ROW[1:], DEDUP_ROW[1:]]
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


def _stage_ms(shape, kd, vd, seed: int, passes: int,
              reps: int = 3) -> dict:
    """Device ms of each stage of K3's sort of a long row of random
    codes, read from one torch.profiler trace (`utils.prof.device_trace`)
    of reps + 1 `sort_rows_cuda` calls, each on the input restored; the
    first is a warm-up and not read (a trace may lose the first kernel it
    sees), the rest give medians.  `stage_ms` lists the spans' sort inside
    shared memory (sort_spans), each merge pass (its merge_partition
    launch and its merge_pass) and the copy home (0 after an even pass
    count); `partition_ms` the partition launches alone.  The result
    must equal the plain version's keys.  Runs in a process of its own
    (`_stage_ms_apart`)."""
    from findkmer_torch.utils.prof import device_trace

    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = _sort_input(shape, kd, "random", gen)
    vsrc = None if vd is None else torch.ones(shape, dtype=vd,
                                              device="cuda")
    kbuf = torch.empty_like(src)
    vbuf = None if vsrc is None else torch.empty_like(vsrc)
    with tempfile.TemporaryDirectory(prefix="k3_trace_") as d:
        with device_trace(d):
            for _ in range(reps + 1):
                kbuf.copy_(src)
                if vbuf is not None:
                    vbuf.copy_(vsrc)
                sort_rows_cuda(kbuf, vbuf)
            torch.cuda.synchronize()
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as f:
            events = json.load(f)["traceEvents"]
    if not torch.equal(kbuf, sort_rows_reference(src)[0]):
        raise AssertionError("K3 under the profiler != plain")
    dev = sorted((e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy")),
                 key=lambda e: e["ts"])
    # after each sort_spans: the passes, then the copies home
    want_seq = (["merge_partition", "merge_pass"] * passes
                + ["gpu_memcpy"] * ((passes % 2) * (1 if vbuf is None
                                                   else 2)))
    starts = [i for i, e in enumerate(dev) if "sort_spans" in e["name"]]
    runs = []
    for i in starts[-reps:]:
        seq = dev[i + 1:i + 1 + len(want_seq)]
        if len(seq) != len(want_seq) or not all(
                w == e["cat"] if w == "gpu_memcpy" else f"::{w}<" in e["name"]
                for w, e in zip(want_seq, seq)):
            raise AssertionError(
                f"K3's trace of {tuple(shape)} after sort_spans: "
                f"{[e['name'][:60] for e in seq]}")
        ms = [e["dur"] / 1000 for e in dev[i:i + 1 + len(want_seq)]]
        part, merge = ms[1:2 * passes:2], ms[2:2 * passes + 1:2]
        runs.append([ms[0]] + [a + b for a, b in zip(part, merge)]
                    + [sum(ms[2 * passes + 1:])] + part)
    if len(runs) != reps:
        raise AssertionError(f"K3's trace of {tuple(shape)} shows "
                             f"{len(starts)} of {reps + 1} sorts")
    med = [statistics.median(r[i] for r in runs) for i in range(len(runs[0]))]
    return {"stage_ms": med[:passes + 2], "partition_ms": med[passes + 2:]}


# `_stage_ms` of each long row in a process of its own: a second
# torch.profiler session in one process may record no device events, and
# this process keeps its one for phase 14's `--profile` check
STAGE_PROBE = (
    "import json, sys, torch\n"
    "import chip_smoke as cs\n"
    "rows = json.loads(sys.argv[1])\n"
    "dt = lambda s: None if s is None else getattr(torch, s[len('torch.'):])\n"
    "print(json.dumps({name: cs._stage_ms(shape, dt(kd), dt(vd), seed, n)\n"
    "                  for name, shape, kd, vd, seed, n in rows}))\n")


def _stage_ms_apart(rows: list) -> dict:
    """{name: `_stage_ms`} of rows [name, shape, keys dtype, vals dtype
    (str or None), seed, merge passes], in one child process."""
    res = subprocess.run(
        [sys.executable, "-c", STAGE_PROBE, json.dumps(rows)], cwd=REPO,
        capture_output=True, text=True)
    if res.returncode:
        raise AssertionError(f"K3's stage trace exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.splitlines()[-1])


def phase_rowsort_timing(seed: int) -> dict:
    """Median CUDA-event ms of K3 and of the library call (`torch.sort`,
    plus a gather of the payload: the plain version too) at the production
    row-sort shapes and at one long row of 2^22 and of 2^26 slots, random
    codes, timed in turn.  The kernel sorts in place: each of its runs
    first restores the unsorted input (`copy`, timed alone too); its ms
    is kernel+copy minus copy.  The bound counts keys and payload read
    once and written once, and the operations: the network's
    compare-exchanges on a row of up to a tile (P/2 a stage, log2(P)
    (log2(P) + 1) / 2 stages, P = next_pow2(C)), a comparison a slot and
    level of the merge sort (log2(P) levels) on a longer one.  The long
    rows also take the device ms of each stage from a profiler trace in a
    child process (`_stage_ms_apart`), the pass count (each stage reads
    and writes the row once) and the pass-count bound: that many times
    the bytes bound."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    timing = {}
    long_rows = []
    for name, shape, kd, vd in SORT_SHAPES + (LONG_ROW, DEDUP_ROW):
        src = _sort_input(shape, kd, "random", gen)
        vsrc = None if vd is None else torch.ones(shape, dtype=vd,
                                                  device="cuda")
        kbuf = torch.empty_like(src)
        vbuf = None if vsrc is None else torch.empty_like(vsrc)
        G, C = shape
        plan = sort_plan(G, C, src.element_size(),
                         0 if vsrc is None else vsrc.element_size())

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
        # the network's compare-exchanges on a row of up to a tile, one
        # comparison a slot a level of the merge sort on a longer one
        log_p = (C - 1).bit_length()
        bound = _bound(2 * src.numel() * slot,
                       src.numel() * log_p if plan.long_row
                       else G * (1 << log_p >> 1) * log_p * (log_p + 1) / 2)
        timing[name] = {"shape": list(shape), "keys": str(kd),
                        "vals": str(vd), **t,
                        "library_ms": t["plain"]["ms"], **bound,
                        "share_of_bound": bound["bound_ms"] / t["kernel"]["ms"]}
        if plan.long_row:
            # the spans' sort, each merge pass, the copy home after odd
            passes = 1 + plan.passes + plan.passes % 2
            timing[name].update(
                passes=passes, merge_passes=plan.passes,
                pass_bound_ms=passes * bound["bound_ms"],
                share_of_pass_bound=passes * bound["bound_ms"]
                / t["kernel"]["ms"])
            long_rows.append([name, shape, str(kd), None if vd is None
                              else str(vd), seed + 3, plan.passes])
        del src, vsrc, kbuf, vbuf
        torch.cuda.empty_cache()
    for name, stages in _stage_ms_apart(long_rows).items():
        timing[name].update(stages)
    say("rowsort_timing", timing=timing)
    return timing


class _LongRows:
    """K3's launches on rows longer than a tile (`sort_rows_cuda.
    long_launches`: the merge passes) as a counter with `launches`, so the
    phases count them from 0 beside the wrappers' own."""

    @property
    def launches(self) -> int:
        return sort_rows_cuda.long_launches

    @launches.setter
    def launches(self, n: int) -> None:
        sort_rows_cuda.long_launches = n


SORT_LONG = _LongRows()
# each kernel's launch counter, by its name in the summary line
WRAPPERS = {"histogram_cuda": histogram_cuda,
            "fused_window_histogram_cuda": fused_window_histogram_cuda,
            "sort_rows_cuda": sort_rows_cuda,
            "sort_rows_cuda_long": SORT_LONG}


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


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 24)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _sha256_and_delete(path: str) -> tuple:
    digest, size = _sha256(path), os.path.getsize(path)
    os.unlink(path)
    return digest, size


def phase_sparse_main_path(tmp: str, fasta: str) -> tuple:
    """The 256 Mbase genome through the CLI at k=21 --canonical and
    k=15: K3 on every row sort, outputs equal to the plain row sort's."""
    runs = []
    with _RowSortTap() as tap:
        tap.timed = True
        sort_rows_cuda.launches = 0
        sort_rows_cuda.long_launches = 0
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
        if sort_rows_cuda.long_launches:
            raise AssertionError(
                f"a plain count sorted {sort_rows_cuda.long_launches} rows "
                "longer than a tile (no dedup expected)")
    return sort_rows_cuda.launches, sort_rows_cuda.long_launches, runs


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


# phase 11 runs on a genome of its own, a quarter of the main paths' in
# bases and in batch rows: the same five batches and checkpoint schedule,
# and a quarter of the bytes for zlib, which is nearly all of the phase
STREAM_GENOME_BASES = GENOME_BASES // 4
STREAM_GEOM = ["--batch-rows", "256", "--chunk-len", "65536", "--device",
               "cuda"]
STREAM_SPARSE = ["-k", "21", "--canonical"]
# three runs of ~16 M entries (~0.25 GB) or more: a compaction a batch,
# and a store of one batch's distinct 21-mers (~16 M) is over the capacity
SPILL_FLAGS = ["--sparse-capacity", str(1 << 23),
               "--sparse-compact-entries", str(1 << 24)]
# row sorts of the sparse stream over the seeded genome (phase_stream)
SPARSE_STREAM_SORTS = 4
STAT_TOTALS = ("records", "bases", "valid_bases", "batches", "rows",
               "h2d_bytes")


class _Tap:
    """Times every call of `owner.name` (host seconds, the device drained
    after it) and keeps what `after()` returns beside each."""

    def __init__(self, owner, name: str, after):
        self.owner, self.name, self.after = owner, name, after
        self.calls = []
        self._orig = getattr(owner, name)

    def __enter__(self):
        def tapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*args, **kw)
            torch.cuda.synchronize()
            self.calls.append({"seconds": time.perf_counter() - t0,
                               **self.after(*args)})
            return out

        setattr(self.owner, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._orig)


def _dir_bytes(d: str, suffix: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
               if n.endswith(suffix))


def _hashed(out: str, want: str, what: str) -> tuple:
    digest, size = _sha256_and_delete(out)
    if digest != want:
        raise AssertionError(f"{what}: sha256 {digest} differs from the "
                             f"count run's {want}")
    return digest, size


def _cli_process(args, **popen_kw) -> subprocess.Popen:
    """`python3 -m findkmer_torch.cli <args>` as a process of its own."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "findkmer_torch.cli"] + args, env=env,
        cwd=REPO, stdout=subprocess.DEVNULL, **popen_kw)


def _kill_then_resume(args, resume_args, ready, what: str) -> dict:
    """Start `stream <args>` as a process, SIGKILL it once `ready()`, then
    run `stream <resume_args>` to its end.  -> the resumed run's --stats
    json, with the seconds of both runs."""
    t0 = time.perf_counter()
    proc = _cli_process(args, stderr=subprocess.DEVNULL)
    try:
        while proc.poll() is None and not ready():
            if time.perf_counter() - t0 > 600:
                raise AssertionError(f"{what}: no checkpoint in 600 s")
            time.sleep(0.05)
        if proc.poll() is not None:
            raise AssertionError(
                f"{what}: the stream ended (exit {proc.returncode}) before "
                "it could be killed")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    killed_after = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = _cli_process(resume_args + ["--stats", "json"],
                        stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the resumed stream exited "
                             f"{proc.returncode}: {err[-2000:]}")
    stats = json.loads([ln for ln in err.splitlines()
                        if ln.startswith("{")][-1])
    return {**stats, "killed_after_s": killed_after,
            "resume_s": time.perf_counter() - t0}


def phase_stream(tmp: str, seed: int) -> dict:
    """The restartable stream, the disk spill and the heap-merge finalize
    over a seeded genome of STREAM_GENOME_BASES (phase 11 of the module
    docstring), each output held to the `count` run of the same flags.
    -> {kernel: {run: launches}} of the runs made in this process, the
    counts set to 0 just before each run and read just after it (the
    killed and resumed streams are processes of their own: not
    counted)."""
    fasta = os.path.join(tmp, "stream_genome.fa")
    write_genome(fasta, seed + 5, total=STREAM_GENOME_BASES)
    want = {}
    for name, flags in (("dense", ["-k", "8"]), ("sparse", STREAM_SPARSE)):
        out = os.path.join(tmp, f"count_{name}.tsv")
        stats, _ = run_cli(["count", "-i", fasta, "-o", out, "--stats",
                            "json"] + flags + STREAM_GEOM)
        want[name], _ = _sha256_and_delete(out)
        want[f"{name}_phases"] = stats["phases"]
        say("stream_reference_count", run=name, sha256=want[name],
            bases=STREAM_GENOME_BASES, wall_s=stats["wall_s"],
            batches=stats["batches"])
    by_run = {name: {} for name in WRAPPERS}

    def counted_run(run: str, *cli, **kw):
        """run_cli with every kernel's count set to 0 just before and read
        just after -> (stats, wall, {kernel: launches})."""
        for fn in WRAPPERS.values():
            fn.launches = 0
        stats, wall = run_cli(*cli, **kw)
        launched = {name: fn.launches for name, fn in WRAPPERS.items()}
        for name, n in launched.items():
            by_run[name][run] = n
        return stats, wall, launched

    def checkpoints(stats) -> dict:
        """The checkpoints of a finished stream: each file's batch and
        bytes, and the seconds of their three parts from --stats json."""
        files = sorted(n for n in os.listdir(ck) if n.endswith(".npz"))
        ph = stats["phases"]
        parts = {part: ph[f"checkpoint/{part}"]
                 for part in ("compact", "d2h", "zlib")}
        if {p["calls"] for p in parts.values()} != {len(files)}:
            raise AssertionError(
                f"{len(files)} checkpoint files for the phases {parts}")
        return {"files": [{"batch": int(n[5:15]), "file_bytes":
                           os.path.getsize(os.path.join(ck, n))}
                          for n in files],
                **{f"{part}_s": p["total_s"] for part, p in parts.items()},
                "seconds": sum(p["total_s"] for p in parts.values())}

    ck = os.path.join(tmp, "ck")
    out = os.path.join(tmp, "stream.tsv")

    def stream_args(flags, every=("--checkpoint-every", "2")):
        return (["stream", "-i", fasta, "-o", out, "--checkpoint", ck,
                 *every] + flags + STREAM_GEOM)

    # 1. dense: K2 once a batch; by the two-stage step K1 once a batch
    for dense_kernel, name in (("fused", "fused_window_histogram_cuda"),
                               ("two_stage", "histogram_cuda")):
        stats, wall, launched = counted_run(
            f"stream_dense_{dense_kernel}",
            stream_args(["-k", "8", "--stats", "json"]),
            dense_kernel=dense_kernel)
        saves = checkpoints(stats)
        others = {n: c for n, c in launched.items() if n != name and c}
        if launched[name] != stats["batches"] or others or not saves["files"]:
            raise AssertionError(
                f"dense stream ({dense_kernel}): launches {launched} and "
                f"{len(saves['files'])} checkpoints for {stats['batches']} "
                "batches")
        digest, size = _hashed(out, want["dense"],
                               f"dense stream ({dense_kernel})")
        say("stream_dense", k=8, dense_kernel=dense_kernel,
            batches=stats["batches"], launches=launched[name],
            checkpoints=saves, wall_s=wall, out_bytes=size,
            sha256=digest, identical_to_count=True)
        shutil.rmtree(ck)

    # 2. sparse: every row sort of the run is a K3 launch.  Checkpoints
    # follow batches 2, 4 and 5: three compactions, and the squeeze of the
    # first table to its live ladder (the later ones are at theirs)
    with _RowSortTap() as sorts:
        full, wall, launched = counted_run(
            "stream_sparse", stream_args(STREAM_SPARSE + ["--stats", "json"]))
    saves = checkpoints(full)
    k3 = launched["sort_rows_cuda"]
    if (k3 != sorts.calls or k3 != SPARSE_STREAM_SORTS
            or launched["sort_rows_cuda_long"]
            or len(saves["files"]) != 3
            or launched["histogram_cuda"]
            or launched["fused_window_histogram_cuda"]):
        raise AssertionError(
            f"sparse stream: launches {launched} for {sorts.calls} row "
            f"sorts ({SPARSE_STREAM_SORTS} expected) and "
            f"{len(saves['files'])} checkpoints")
    digest, size = _hashed(out, want["sparse"], "sparse stream")
    say("stream_sparse", args=STREAM_SPARSE, batches=full["batches"],
        k3_launches=k3, row_sorts=sorts.calls, checkpoints=saves,
        checkpoint_s=saves["seconds"], wall_s=wall,
        cli_wall_s=full["wall_s"], phases=full["phases"], out_bytes=size,
        sha256=digest, identical_to_count=True)
    shutil.rmtree(ck)
    torch.cuda.empty_cache()

    # 3. kill and resume, each run a process of its own
    # (the resumed run takes the default --checkpoint-every: it writes the
    # final checkpoint alone, each being nearly all zlib)
    resumed = _kill_then_resume(
        stream_args(STREAM_SPARSE), stream_args(STREAM_SPARSE, every=()),
        lambda: os.path.exists(os.path.join(ck, "latest.json")),
        "kill and resume")
    digest, size = _hashed(out, want["sparse"], "resumed sparse stream")
    totals = {key: resumed[key] for key in STAT_TOTALS}
    if totals != {key: full[key] for key in STAT_TOTALS}:
        raise AssertionError(
            f"resumed stream: totals {totals} differ from the uninterrupted "
            f"run's {full}")
    say("stream_kill_resume", args=STREAM_SPARSE,
        killed_after_s=resumed["killed_after_s"],
        resume_s=resumed["resume_s"], resume_cli_wall_s=resumed["wall_s"],
        checkpoints=sorted(n for n in os.listdir(ck) if n.endswith(".npz")),
        totals=totals, out_bytes=size, sha256=digest,
        identical_to_count=True, totals_equal_uninterrupted=True)
    shutil.rmtree(ck)

    # 4. spill: count --spill, then stream --spill --checkpoint killed
    # after a checkpoint that follows a spill
    sp = os.path.join(tmp, "sp")

    def spilled(counter, store):
        codes, counts = (os.path.join(sp, f"run{counter._spill_n - 1:05d}."
                                      f"{part}.npy")
                         for part in ("codes", "counts"))
        return {"run": counter._spill_n - 1,
                "entries": (os.path.getsize(codes) - 128) // 8,
                "file_bytes": os.path.getsize(codes) + os.path.getsize(counts)}

    with _Tap(KmerCounter, "_spill_store", spilled) as tap, \
            _RowSortTap() as sorts:
        stats, wall, launched = counted_run(
            "count_spill",
            ["count", "-i", fasta, "-o", out, "--spill", sp, "--stats",
             "json"] + STREAM_SPARSE + SPILL_FLAGS + STREAM_GEOM)
    left = sorted(os.listdir(sp))
    if len(tap.calls) < 3 or left != ["stream.token"]:
        raise AssertionError(
            f"spill: {len(tap.calls)} runs written, {left} left in the dir")
    # the dedup before each spill decision sorts the store as one row
    if (launched["sort_rows_cuda"] != sorts.calls
            or not launched["sort_rows_cuda_long"]):
        raise AssertionError(
            f"count --spill: launches {launched} for {sorts.calls} row sorts")
    digest, size = _hashed(out, want["sparse"], "count --spill")
    ph = stats["phases"]
    say("spill_count", args=STREAM_SPARSE + SPILL_FLAGS, runs=tap.calls,
        runs_written=len(tap.calls),
        bytes_spilled=sum(c["file_bytes"] for c in tap.calls),
        spill_s=sum(c["seconds"] for c in tap.calls),
        residual_pull_s=ph["finalize/residual_pull"]["total_s"],
        merge_s=ph["finalize/merge"]["total_s"],
        merge_blocks=ph["finalize/merge"]["calls"],
        k3_launches=launched["sort_rows_cuda"],
        k3_long_launches=launched["sort_rows_cuda_long"],
        row_sorts=sorts.calls, wall_s=wall,
        cli_wall_s=stats["wall_s"], bases_per_s=stats["bases_per_s"],
        phases=ph, out_bytes=size, sha256=digest, identical_to_count=True,
        run_files_left=0)
    shutil.rmtree(sp)
    torch.cuda.empty_cache()

    def checkpoint_follows_a_spill():
        try:
            with open(os.path.join(ck, "latest.json")) as f:
                return json.load(f)["extra"].get("spill_runs", 0) >= 1
        except (OSError, ValueError):
            return False

    spill_args = STREAM_SPARSE + SPILL_FLAGS + ["--spill", sp]
    resumed = _kill_then_resume(
        stream_args(spill_args), stream_args(spill_args, every=()),
        checkpoint_follows_a_spill, "spill + checkpoint")
    digest, size = _hashed(out, want["sparse"],
                           "resumed stream --spill --checkpoint")
    left = sorted(os.listdir(sp))
    if left != ["stream.token"]:
        raise AssertionError(f"resumed spill: {left} left in the dir")
    say("stream_spill_kill_resume", args=STREAM_SPARSE + SPILL_FLAGS,
        killed_after_s=resumed["killed_after_s"],
        resume_s=resumed["resume_s"], resume_cli_wall_s=resumed["wall_s"],
        checkpoint_bytes=_dir_bytes(ck, ".npz"), out_bytes=size,
        sha256=digest, identical_to_count=True, run_files_left=0)
    shutil.rmtree(ck)
    shutil.rmtree(sp)

    # 5. the heap-merge finalize, beside the ordered one
    os.environ["FINDKMER_ORDERED_FINALIZE"] = "0"
    try:
        with _RowSortTap() as sorts:
            stats, wall, launched = counted_run(
                "count_heap_merge",
                ["count", "-i", fasta, "-o", out, "--stats", "json"]
                + STREAM_SPARSE + STREAM_GEOM)
    finally:
        del os.environ["FINDKMER_ORDERED_FINALIZE"]
    os.unlink(fasta)
    if not sorts.calls or launched["sort_rows_cuda"] != sorts.calls:
        raise AssertionError(
            f"heap-merge count: launches {launched} for {sorts.calls} row "
            "sorts")
    digest, size = _hashed(out, want["sparse"], "heap-merge finalize")
    ordered = want["sparse_phases"]
    say("heap_merge_finalize", args=STREAM_SPARSE,
        k3_launches=launched["sort_rows_cuda"],
        finalize_s=stats["phases"]["finalize"]["total_s"],
        write_s=stats["phases"]["write"]["total_s"],
        ordered_finalize_s=ordered["finalize"]["total_s"],
        ordered_write_s=ordered["write"]["total_s"],
        phases=stats["phases"], ordered_phases=ordered, wall_s=wall,
        cli_wall_s=stats["wall_s"], out_bytes=size, sha256=digest,
        identical_to_count=True)
    torch.cuda.empty_cache()
    if not all(sum(runs.values()) for runs in by_run.values()):
        raise AssertionError(f"stream phase: a kernel never ran: {by_run}")
    say("stream_launches", **by_run)
    return by_run


# `count --spill` in a process of its own from the checkout it runs in:
# the peak of device memory its tensors held, on stderr beside --stats json
SPILL_PROBE = (
    "import json, sys, torch\n"
    "from findkmer_torch import cli\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print(json.dumps({'peak_bytes': torch.cuda.max_memory_allocated()}),"
    " file=sys.stderr)\n"
    "sys.exit(rc)\n")


def phase_spill_ab(tmp: str, seed: int, against: str) -> dict:
    """Phase 11's `count --spill` (its genome and flags) from this
    checkout and from `against`, another checkout of the port (the parent
    commit, unpacked), each run a process of its own, in turn: this,
    against, against, this.  Each run's wall, `dispatch` seconds (the
    compactions and dedups: K3 inside) and peak device memory
    (`torch.cuda.max_memory_allocated`); every output sha256-equal.
    Without `against`, this checkout four times."""
    fasta = os.path.join(tmp, "stream_genome.fa")
    write_genome(fasta, seed + 5, total=STREAM_GENOME_BASES)
    trees = {"this": REPO, "against": os.path.abspath(against or REPO)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for tree in set(trees.values()):  # each builds its kernels first
        subprocess.run([sys.executable, "-c", "from findkmer_torch.ops.cuda "
                        "import _build; _build.load()"], cwd=tree, env=env,
                       check=True)
    runs, digests = {name: [] for name in trees}, set()
    for name in ("this", "against", "against", "this"):
        sp, out = os.path.join(tmp, "sp"), os.path.join(tmp, "spill.tsv")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", SPILL_PROBE, "count", "-i", fasta, "-o",
             out, "--spill", sp, "--stats", "json"] + STREAM_SPARSE
            + SPILL_FLAGS + STREAM_GEOM,
            cwd=trees[name], env=env, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        if res.returncode:
            raise AssertionError(f"count --spill in {trees[name]} exited "
                                 f"{res.returncode}: {res.stderr[-2000:]}")
        lines = [json.loads(ln) for ln in res.stderr.splitlines()
                 if ln.startswith("{")]
        stats = next(ln for ln in lines if "phases" in ln)
        peak = next(ln["peak_bytes"] for ln in lines if "peak_bytes" in ln)
        digest, size = _sha256_and_delete(out)
        digests.add(digest)
        shutil.rmtree(sp)
        run = {"tree": trees[name], "process_wall_s": wall,
               "cli_wall_s": stats["wall_s"],
               "dispatch_s": stats["phases"]["dispatch"]["total_s"],
               "peak_device_bytes": peak, "out_bytes": size,
               "sha256": digest}
        runs[name].append(run)
        say("spill_ab_run", which=name, **run)
    os.unlink(fasta)
    if len(digests) != 1:
        raise AssertionError(f"count --spill outputs differ: {digests}")
    say("spill_ab", args=STREAM_SPARSE + SPILL_FLAGS, **{
        name: {key: [r[key] for r in rs] for key in (
            "cli_wall_s", "dispatch_s", "peak_device_bytes")}
        for name, rs in runs.items()}, sha256=digests.pop())
    return runs


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
            _write_record(f, f"chr{r + 1} seeded record {r + 1}", seq)


def _write_record(f, header: str, seq: np.ndarray) -> None:
    """One FASTA record of the uint8 bases `seq`, 80 bases a line."""
    f.write(f">{header}\n".encode())
    full = seq.size // 80 * 80
    body = np.empty((full // 80, 81), np.uint8)
    body[:, :80] = seq[:full].reshape(-1, 80)
    body[:, 80] = ord("\n")
    f.write(body.tobytes())
    if seq.size > full:
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
        # each route once (the mirrored second pass went when the stream
        # phase took its place in the time budget)
        order = list(DENSE_ROUTES)
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
                   "sha256": hashlib.sha256(got).hexdigest(),
                   "batches": n, "k1_launches": k1, "k2_launches": k2,
                   "bases": stats["bases"], "cli_wall_s": stats["wall_s"],
                   "bases_per_s": stats["bases_per_s"], "wall_s": wall,
                   "device": stats["device"]}
            say("main_path", **run)
            runs.append(run)
        say("main_path_identical", k=k, args=extra, runs=len(order),
            bytes=len(want_bytes),
            sha256=hashlib.sha256(want_bytes).hexdigest())
    if sort_rows_cuda.launches:
        raise AssertionError("the dense path launched the row sort")
    return (histogram_cuda.launches, fused_window_histogram_cuda.launches,
            runs)


# phase 15: the installed package.  The runs it makes on the main paths'
# genome, each held to the checkout's run of the same flags
INSTALLED_RUNS = (("k8", ["-k", "8"]),
                  ("k21_canonical", ["-k", "21", "--canonical"]))
INSTALLED_GEOM = ["--batch-rows", str(PROD_SHAPE[0]), "--chunk-len",
                  str(PROD_SHAPE[1]), "--device", "cuda"]
# what `pip wheel` of a checkout does not read: the top-level build
# outputs and the repository's history, and caches at any depth
NOT_PACKAGED = {".git", "build"}
NEVER_PACKAGED = {"__pycache__", ".pytest_cache", ".hypothesis"}
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check",
       "--no-input"]
# the child of phase 15, run from the installed tree: builds the kernels
# and the C encoder into the empty cache, then counts; one JSON line
_INSTALLED_CHILD = """
import contextlib, io, json, sys, time
t0 = time.perf_counter()
import findkmer_torch
from findkmer_torch import cli, pipeline
from findkmer_torch.io import native
from findkmer_torch.ops.cuda import _build
from findkmer_torch.ops.cuda.histogram_kernel import histogram_cuda
from findkmer_torch.ops.cuda.rowsort_kernel import sort_rows_cuda
from findkmer_torch.ops.cuda.window_histogram_kernel import (
    fused_window_histogram_cuda)
import_s = time.perf_counter() - t0
fasta, out, runs, geom = json.loads(sys.argv[1])
t0 = time.perf_counter()
_build.load()
kernels_s = time.perf_counter() - t0
t0 = time.perf_counter()
encoder = pipeline.host_encoder()
encoder_s = time.perf_counter() - t0
report = {"package": findkmer_torch.__file__, "csrc": str(_build.CSRC),
          "sources": [p.name for p in _build.sources()],
          "library": str(_build.library_path()),
          "native_source": str(native.SOURCE),
          "native_lib": str(native.lib_path()), "host_encoder": encoder,
          "import_s": import_s, "kernels_build_s": kernels_s,
          "encoder_build_s": encoder_s, "runs": {}}
for name, flags in runs:
    histogram_cuda.launches = fused_window_histogram_cuda.launches = 0
    sort_rows_cuda.launches = sort_rows_cuda.long_launches = 0
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["count", "-i", fasta, "-o", f"{out}.{name}.tsv",
                       "--stats", "json", *flags, *geom])
    wall = time.perf_counter() - t0
    if rc:
        raise SystemExit(f"count {flags} exited {rc}: {err.getvalue()}")
    report["runs"][name] = {
        "stats": json.loads(err.getvalue().strip().splitlines()[-1]),
        "wall_s": wall, "launches": {
            "histogram_cuda": histogram_cuda.launches,
            "fused_window_histogram_cuda":
                fused_window_histogram_cuda.launches,
            "sort_rows_cuda": sort_rows_cuda.launches,
            "sort_rows_cuda_long": sort_rows_cuda.long_launches}}
report["jax_package"] = "findkmer_tpu" in sys.modules
print(json.dumps(report))
"""


def _not_packaged(root: str, names: list) -> list:
    top = os.path.abspath(root) == REPO
    return [n for n in names if n in NEVER_PACKAGED or n.endswith(".egg-info")
            or (top and n in NOT_PACKAGED)]


def _pip(args: list, cwd: str) -> float:
    """pip with $CC, then, if that fails and $CC is another compiler, once
    more with cc: the rule of the port's own C build (a $CC without
    OpenMP cannot link the JAX package's encoder, which the wheel holds
    too).  -> seconds."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    res = subprocess.run(PIP + args, cwd=cwd, env=env, capture_output=True,
                         text=True)
    if res.returncode and env.get("CC", "cc") != "cc":
        shutil.rmtree(os.path.join(cwd, "build"), ignore_errors=True)
        res = subprocess.run(PIP + args, cwd=cwd, env={**env, "CC": "cc"},
                             capture_output=True, text=True)
    if res.returncode:
        raise AssertionError(f"pip {args[0]} exited {res.returncode}: "
                             f"{(res.stdout + res.stderr)[-3000:]}")
    return time.perf_counter() - t0


def _counted(argv: list) -> tuple:
    """run_cli with every kernel's count set to 0 just before and read
    just after -> (stats, {kernel: launches})."""
    for w in WRAPPERS.values():
        w.launches = 0
    stats, _ = run_cli(argv)
    return stats, {name: w.launches for name, w in WRAPPERS.items()}


def checkout_counts(tmp: str, fasta: str) -> dict:
    """This checkout's own runs of INSTALLED_RUNS over `fasta` (phase 15's
    yardstick where phases 6 and 7 did not run) -> {run: {sha256,
    launches}}."""
    want = {}
    for name, flags in INSTALLED_RUNS:
        out = os.path.join(tmp, f"checkout_{name}.tsv")
        _, launched = _counted(["count", "-i", fasta, "-o", out]
                               + flags + INSTALLED_GEOM)
        want[name] = {"sha256": _sha256_and_delete(out)[0],
                      "launches": launched}
        say("installed_yardstick", run=name, **want[name])
    return want


def _under(path: str, root: str) -> bool:
    return Path(path).resolve().is_relative_to(Path(root).resolve())


def phase_installed(tmp: str, fasta: str, want: dict, smi: str) -> dict:
    """The installed package (phase 15 of the module docstring): `want` is
    {run: {sha256, launches}} of this checkout's runs of INSTALLED_RUNS.
    -> {kernel: its launches in the installed runs}, counted from 0 in the
    child."""
    t_phase = time.perf_counter()
    d = os.path.join(tmp, "installed")
    src, target = os.path.join(d, "src"), os.path.join(d, "target")
    cache, out = os.path.join(d, "cache"), os.path.join(d, "count")
    t0 = time.perf_counter()
    shutil.copytree(REPO, src, ignore=_not_packaged, symlinks=True)
    copy_s = time.perf_counter() - t0
    wheel_s = _pip(["wheel", "--no-build-isolation", "--no-deps",
                    "--no-index", "--no-cache-dir", "-q", "-w",
                    os.path.join(d, "wheel"), src], src)
    (wheel,) = Path(d, "wheel").glob("*.whl")
    install_s = _pip(["install", "--no-deps", "--no-index", "--no-cache-dir",
                      "-q", "--target", target, str(wheel)], d)
    shutil.rmtree(src)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "FINDKMER_TORCH_CACHE")}
    env.update(PYTHONPATH=target, FINDKMER_TORCH_CACHE=cache)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-P", "-c", _INSTALLED_CHILD, json.dumps(
            [fasta, out, INSTALLED_RUNS, INSTALLED_GEOM])],
        cwd=d, env=env, capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    if res.returncode:
        raise AssertionError(f"installed child exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    rep = json.loads(res.stdout.strip().splitlines()[-1])
    where = {key: rep[key] for key in ("package", "csrc", "library",
                                       "native_source", "native_lib")}
    roots = {"package": target, "csrc": target, "native_source": target,
             "library": os.path.join(cache, "kernels"),
             "native_lib": os.path.join(cache, "native")}
    wrong = {key: p for key, p in where.items() if not _under(p, roots[key])}
    if (wrong or rep["jax_package"] or rep["host_encoder"] != "native"
            or rep["sources"] != [p.name for p in _build.sources()]):
        raise AssertionError(f"installed child: outside its tree {wrong}, "
                             f"report {rep}")
    launched = dict.fromkeys(WRAPPERS, 0)
    card = torch.cuda.get_device_name(0)
    for name, _ in INSTALLED_RUNS:
        run = rep["runs"][name]
        stats = run["stats"]
        digest, size = _sha256_and_delete(f"{out}.{name}.tsv")
        if (digest != want[name]["sha256"]
                or run["launches"] != want[name]["launches"]
                or stats["device"] != card
                or stats["host_encoder"] != "native"):
            raise AssertionError(
                f"installed {name}: sha256 {digest}, launches "
                f"{run['launches']}, device {stats['device']}, encoder "
                f"{stats['host_encoder']}; the checkout's {want[name]}")
        for kernel, n in run["launches"].items():
            launched[kernel] += n
        say("installed_run", run=name, sha256=digest, out_bytes=size,
            identical_to_checkout=True, launches=run["launches"],
            device=stats["device"], host_encoder=stats["host_encoder"],
            batches=stats["batches"], bases_per_s=stats["bases_per_s"],
            wall_s=run["wall_s"])
    shutil.rmtree(d)
    say("installed", **where, wheel=wheel.name, copy_s=copy_s,
        wheel_s=wheel_s, install_s=install_s, child_s=child_s,
        import_s=rep["import_s"], kernels_build_s=rep["kernels_build_s"],
        encoder_build_s=rep["encoder_build_s"], launches=launched,
        card=smi, seconds=time.perf_counter() - t_phase)
    return launched


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


def write_records(path: str, seed: int, n: int) -> int:
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
    bases = write_records(records, seed + 7, PER_RECORD_RECORDS)
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
        if (got["cuda"] != got["cpu"]
                or got["cuda"].count(b">") != PER_RECORD_RECORDS):
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


FILTER_REF_BASES = 8 << 20     # a pair of bacterial genomes
FILTER_READS = 1_000_000       # 150 bp FASTQ reads: 150 Mbase
# the pair and FASTA runs at the depth that leaves phase 13 its time
FILTER_PAIRS = 100_000
FILTER_SUBSET = 50_000         # the k = 15 and k = 31 runs
# the FASTA runs: the list flow parses and emits in Python per read, so
# 1 M reads would add ~40 s to the smoke and nothing to the check
FASTA_READS = 50_000
READ_LEN = 150
FRAGMENT = 400                 # a pair's insert: R2 is its far end, revcomp
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE_OF = np.zeros(256, np.uint8)  # A, C, G, T -> 0..3 (others 0)
_CODE_OF[_ACGT] = np.arange(4, dtype=np.uint8)


def _draw(genome: np.ndarray, n: int, length: int,
          rng: np.random.Generator) -> np.ndarray:
    pos = rng.integers(0, genome.size - length, n)
    return genome[pos[:, None] + np.arange(length)]


def _filter_sequences(ref: np.ndarray, n: int, length: int,
                      rng: np.random.Generator) -> np.ndarray:
    """(n, length) uint8 fragments: half from `ref` with 1% substitutions,
    half from an unrelated seeded genome, shuffled; 0.2% N bases."""
    half = n // 2
    own = _draw(ref, half, length, rng)
    sub = rng.random(own.shape) < 0.01
    own[sub] = _ACGT[rng.integers(0, 4, int(sub.sum()))]
    other = _ACGT[rng.integers(0, 4, ref.size, dtype=np.uint8)]
    seqs = np.concatenate([own, _draw(other, n - half, length, rng)])
    seqs[rng.random(seqs.shape) < 0.002] = ord("N")
    return seqs[rng.permutation(n)]


def _records(seqs: np.ndarray, lead: bytes, tag: bytes, qual) -> np.ndarray:
    """Fixed-width FASTQ (qual given) or FASTA records, one row each:
    lead + 7-digit index + tag, then the sequence."""
    n = seqs.shape[0]
    idx = np.arange(n)
    digits = np.stack([(idx // 10 ** d) % 10 + 48 for d in range(6, -1, -1)],
                      axis=1).astype(np.uint8)

    def const(b: bytes):
        return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))

    parts = [const(lead), digits, const(tag + b"\n"), seqs]
    if qual is not None:
        parts += [const(b"\n+\n"), qual]
    parts.append(const(b"\n"))
    return np.ascontiguousarray(np.concatenate(parts, axis=1))


def write_filter_inputs(tmp: str, seed: int) -> tuple:
    """The filter phase's seeded inputs: a reference genome (FASTA), reads
    as FASTQ, the first of them as FASTA, R1/R2 pairs, and a subset of the
    reads.
    -> (their paths, the first reads' sequences: one device batch)."""
    rng = np.random.default_rng(seed)
    paths = {name: os.path.join(tmp, name) for name in (
        "ref.fa", "reads.fq", "reads.fa", "r1.fq", "r2.fq", "subset.fq")}
    write_genome(paths["ref.fa"], seed, total=FILTER_REF_BASES)
    with open(paths["ref.fa"], "rb") as f:
        ref = np.frombuffer(b"".join(
            ln for ln in f.read().split(b"\n") if not ln.startswith(b">")),
            np.uint8)
    reads = _filter_sequences(ref, FILTER_READS, READ_LEN, rng)
    qual = rng.integers(35, 74, reads.shape, dtype=np.uint8)
    fq = _records(reads, b"@r", b" seeded", qual)
    with open(paths["reads.fq"], "wb") as f:
        f.write(fq)
    with open(paths["subset.fq"], "wb") as f:
        f.write(fq[:FILTER_SUBSET])
    del fq
    with open(paths["reads.fa"], "wb") as f:
        f.write(_records(reads[:FASTA_READS], b">r", b" seeded", None))
    frags = _filter_sequences(ref, FILTER_PAIRS, FRAGMENT, rng)
    r2 = frags[:, ::-1][:, :READ_LEN]
    r2 = np.where(r2 == ord("N"), r2, _ACGT[3 - _CODE_OF[r2]])  # revcomp
    qual = qual[:FILTER_PAIRS]
    for name, seqs, tag in (("r1.fq", frags[:, :READ_LEN], b"/1"),
                            ("r2.fq", r2, b"/2")):
        with open(paths[name], "wb") as f:
            f.write(_records(np.ascontiguousarray(seqs), b"@p", tag, qual))
    return paths, reads[: (256 << 16) // (READ_LEN + 1) + 1].copy()


class _StepTap:
    """Counts the device filter's batch steps (`filter_device._filter_step`)
    and the devices they ran on."""

    def __enter__(self):
        self.devices = collections.Counter()
        self._orig = filter_device._filter_step

        def tapped(members, packed, *args):
            self.devices[packed.device.type] += 1
            return self._orig(members, packed, *args)

        filter_device._filter_step = tapped
        return self

    def __exit__(self, *exc):
        filter_device._filter_step = self._orig


def _run_filter(args, env: dict, outs) -> dict:
    """`findkmer_torch.cli filter <args>` in this process -> wall, the
    kept/seen of its stderr line, the sha256 and bytes of each output
    (then deleted)."""
    err = io.StringIO()
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["filter", *args])
        wall = time.perf_counter() - t0
    finally:
        for key, val in saved.items():
            if val is None:
                del os.environ[key]
            else:
                os.environ[key] = val
    m = re.search(r"kept (\d+)/(\d+)", err.getvalue())
    if rc != 0 or m is None:
        raise AssertionError(f"filter {args} exited {rc}: {err.getvalue()}")
    hashed = [_sha256_and_delete(o) for o in outs]
    return {"wall_s": wall, "kept": int(m.group(1)), "seen": int(m.group(2)),
            "sha256": [h for h, _ in hashed],
            "out_bytes": [b for _, b in hashed]}


def _spectrum_load_split(path: str) -> tuple:
    """Host seconds of a canonical spectrum's load, by part: `parse_s`
    (k inference and the C parser), `fold_s` (the canonical fold), the
    whole `FilterSpec.load` that every run of both engines pays (the parse
    and fold again, from a warm page cache) and `prefilter_s`, the bit
    table that only the host engine builds.  -> (the spec, the seconds)."""
    from findkmer_torch import spectra
    from findkmer_torch.filter import FilterSpec

    clock = time.perf_counter
    t0 = clock()
    k = spectra._infer_k(path, b"\t")
    parsed = spectra._parse_binary(path, k, b"\t")
    if parsed is None:
        raise AssertionError(f"{path}: the C spectrum parser refused it")
    t1 = clock()
    spectra.canonize_runs(*parsed, k)
    t2 = clock()
    spec = FilterSpec.load(path, canonical=True)
    t3 = clock()
    spec.prefilter()
    t4 = clock()
    return spec, {"parse_s": t1 - t0, "fold_s": t2 - t1, "load_s": t3 - t2,
                  "prefilter_s": t4 - t3}


def phase_filter_step(spec_path: str, seqs: np.ndarray) -> dict:
    """The device step alone on one staged batch of 256 x 65536 windows
    (16.7 Mbase of the reads), k = 21 --canonical against the reference's
    spectrum: median CUDA-event ms of the whole step and of its three
    parts, each beside the bytes bound of its own inputs and outputs; and
    the host seconds of loading that spectrum (`_spectrum_load_split`)."""
    from findkmer_torch.io import native

    spec, load = _spectrum_load_split(spec_path)
    dev = filter_device.DeviceFilter(spec, device="cuda")
    k, B, L, R = dev.k, dev.B, dev.L, dev.R
    joined = np.full((seqs.shape[0], READ_LEN + 1), ord("N"), np.uint8)
    joined[:, :READ_LEN] = seqs
    work = np.full(k - 1 + dev.need, 4, np.uint8)
    native.filter_prepare(np.ascontiguousarray(joined.reshape(-1)
                                               [: dev.need]), work[k - 1 :])
    packed, validbits = (torch.from_numpy(a).cuda()
                         for a in native.pack_rows(work, B, L, R))
    members = dev.members
    codes = window_ops.window_codes_packed(packed, validbits, k, True, R=R)
    hit = filter_device.member_hits(members, codes)
    parts = {
        "step": (lambda: filter_device._filter_step(
            members, packed, validbits, k, True, R, L)),
        "extraction": (lambda: window_ops.window_codes_packed(
            packed, validbits, k, True, R=R)),
        "membership": lambda: filter_device.member_hits(members, codes),
        "bitmap": lambda: filter_device.hit_bitmap(hit, B, L),
    }
    wire = packed.nbytes + validbits.nbytes
    bitmap = dev.need // 8
    moved = {"step": wire + dev.member_bytes + bitmap,
             "extraction": wire + codes.nbytes,
             "membership": codes.nbytes + dev.member_bytes + hit.nbytes,
             "bitmap": hit.nbytes + bitmap}
    out = {}
    for name, fn in parts.items():
        ms = _median_ms(fn)
        bound = 1e3 * moved[name] / PEAK_BYTES_PER_S
        out[name] = {"ms": ms, "bytes": moved[name], "bound_ms": bound,
                     "share_of_bound": bound / ms}
    valid = float((codes != window_ops.sentinel(codes.dtype)).float().mean())
    say("filter_device_step", k=k, canonical=True, batch=[B, L],
        bases=dev.need, member_codes=int(members.numel()),
        member_bytes=dev.member_bytes, spectrum_load=load,
        valid_share=valid,
        hit_share=float(hit.float().mean()), device=str(members.device),
        bases_per_s=dev.need / out["step"]["ms"] * 1e3, **out)
    del codes, hit, packed, validbits, dev
    torch.cuda.empty_cache()
    return out


def phase_filter(tmp: str, seed: int) -> dict:
    """Read filtering (phase 12 of the module docstring) -> {kernel: its
    launches in the filter runs} (none of K1-K3 runs there)."""
    t0 = time.perf_counter()
    p, staged = write_filter_inputs(tmp, seed + 21)
    spec = {}
    for k, extra in ((21, ["--canonical"]), (15, []), (31, [])):
        spec[k] = os.path.join(tmp, f"spec{k}.tsv")
        run_cli(["count", "-i", p["ref.fa"], "-k", str(k), "-o", spec[k],
                 "--device", "cuda"] + extra)
    say("filter_inputs", seconds=time.perf_counter() - t0,
        reads=FILTER_READS, pairs=FILTER_PAIRS, read_len=READ_LEN,
        ref_bases=FILTER_REF_BASES,
        bytes={name: os.path.getsize(path) for name, path in p.items()},
        spectrum_bytes={k: os.path.getsize(v) for k, v in spec.items()})
    for fn in WRAPPERS.values():
        fn.launches = 0
    out1 = os.path.join(tmp, "kept.fq")
    pair_outs = [os.path.join(tmp, f"kept{i}.fq") for i in (1, 2)]
    k21 = ["--spectrum", spec[21], "--canonical"]
    device = ["--engine", "device", "--device", "cuda"]
    # (name, args, outputs, bases, the device runs' (environment, engine
    # arguments); no engine arguments = the CLI's defaults, whose auto
    # pick on --device cuda is the device engine)
    runs = [
        ("fastq_canonical", ["-i", p["reads.fq"], "-o", out1] + k21, [out1],
         FILTER_READS, [({}, device), ({"FINDKMER_FILTER_FAST": "0"}, device)]),
        ("fasta_canonical", ["-i", p["reads.fa"], "-o", out1] + k21, [out1],
         FASTA_READS, [({}, device)]),
        ("paired_both_invert",
         ["-i", p["r1.fq"], p["r2.fq"], "--paired", "--pair-mode", "both",
          "--invert", "-o", ",".join(pair_outs)] + k21, pair_outs,
         2 * FILTER_PAIRS, [({}, device)]),
        ("min_frac", ["-i", p["reads.fq"], "-o", out1, "--min-frac", "0.5"]
         + k21, [out1], FILTER_READS, [({}, device)]),
        ("subset_k15", ["-i", p["subset.fq"], "-o", out1, "--spectrum",
                        spec[15]], [out1], FILTER_SUBSET, [({}, device)]),
        ("subset_k31", ["-i", p["subset.fq"], "-o", out1, "--spectrum",
                        spec[31]], [out1], FILTER_SUBSET,
         [({}, device), ({}, [])]),
    ]
    results = []
    with _StepTap() as steps:
        for name, args, outs, n_reads, device_runs in runs:
            host = _run_filter(args + ["--engine", "host"], {}, outs)
            for env, engine_args in device_runs:
                steps.devices.clear()
                got = _run_filter(args + engine_args, env, outs)
                for key in ("kept", "seen", "sha256"):
                    if got[key] != host[key]:
                        raise AssertionError(
                            f"filter {name} {env} {engine_args}: device "
                            f"{key} {got[key]} differs from the host "
                            f"engine's {host[key]}")
                if set(steps.devices) != {"cuda"}:
                    raise AssertionError(
                        f"filter {name} {engine_args}: device steps ran on "
                        f"{steps.devices}")
                run = {"run": name, "env": env,
                       "engine_args": engine_args or "the CLI's defaults",
                       "seen": got["seen"],
                       "kept": got["kept"], "sha256": got["sha256"],
                       "out_bytes": got["out_bytes"],
                       "device_steps": steps.devices["cuda"]}
                for engine, r in (("host", host), ("device", got)):
                    run[f"{engine}_wall_s"] = r["wall_s"]
                    run[f"{engine}_reads_per_s"] = n_reads / r["wall_s"]
                    run[f"{engine}_bases_per_s"] = (n_reads * READ_LEN
                                                    / r["wall_s"])
                say("filter_run", **run, identical_to_host=True)
                results.append(run)
    launched = {name: fn.launches for name, fn in WRAPPERS.items()}
    if any(launched.values()):
        raise AssertionError(f"the filter path launched {launched}")
    step = phase_filter_step(spec[21], staged)
    for path in list(p.values()) + list(spec.values()):
        os.unlink(path)
    say("filter_launches", **launched,
        note="the filter path is plain torch (extraction, searchsorted, "
             "bitmap): none of K1-K3 runs there",
        runs=len(results), step_ms=step["step"]["ms"],
        seconds=time.perf_counter() - t0)
    return launched


# phase 13: a small isolate collection (the Mash `sketch`/`dist` and
# kmtricks matrix workload): 8 samples of one 2 Mbase ancestor, each with
# its own share of substitutions.  A sample's distinct canonical 21-mers
# must stay under the 2^22 store of `sketch -k` (`api.count`, whose
# capacity is not sized from its input)
COHORT_BASES = 2_000_000
COHORT_RATES = tuple(float(r) for r in np.linspace(0.005, 0.05, 8))
COHORT_K = ["-k", "21", "--canonical"]
SKETCH_S = "1000"
# the host tools of phase 13 that stream in Python, in worker processes
# beside the in-process `matrix -k` (each is one Python thread; the card
# is not theirs)
_TOOL_WORKER = """
import contextlib, json, sys, time
from findkmer_torch.cli import main
done = []
for name, argv, stdout in json.loads(sys.argv[1]):
    with open(stdout, "w") as f, contextlib.redirect_stdout(f):
        t0 = time.perf_counter()
        rc = main(argv)
        seconds = time.perf_counter() - t0
    done.append({"tool": name, "rc": rc, "seconds": seconds})
print(json.dumps(done))
"""


def write_cohort(tmp: str, seed: int) -> list:
    """The phase-13 cohort: one seeded ancestor of COHORT_BASES uniform
    bases, and for each rate of COHORT_RATES a sample with that share of
    its bases substituted, plus four N gaps of 100-50000 bases as
    `write_genome` makes them; one record a sample.  -> the FASTA paths."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ancestor = rng.integers(0, 4, COHORT_BASES, dtype=np.uint8)
    paths = []
    for i, rate in enumerate(COHORT_RATES):
        codes = ancestor.copy()
        hit = np.flatnonzero(rng.random(COHORT_BASES) < rate)
        codes[hit] = (codes[hit] + rng.integers(1, 4, hit.size,
                                                dtype=np.uint8)) % 4
        seq = acgt[codes]
        for _ in range(4):
            ln = int(rng.integers(100, 50000))
            s0 = int(rng.integers(0, COHORT_BASES - ln))
            seq[s0 : s0 + ln] = ord("N")
        paths.append(os.path.join(tmp, f"isolate{i + 1}.fa"))
        with open(paths[-1], "wb") as f:
            _write_record(f, f"isolate{i + 1} substitutions {rate:.4f}", seq)
    return paths


def _lines(path: str) -> int:
    n = 0
    with open(path, "rb") as f:
        while block := f.read(1 << 24):
            n += block.count(b"\n")
    return n


def _start_tools(d: str, jobs: list) -> subprocess.Popen:
    """A worker process that runs `jobs` ((name, argv, stdout file)) in
    turn through `findkmer_torch.cli.main` and prints their exit codes and
    seconds as one JSON list."""
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-c", _TOOL_WORKER, json.dumps(jobs)], env=env,
        cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_tools(procs: list) -> dict:
    """Wait for the workers -> {tool: {"rc", "seconds"}}; a worker that
    fails fails the phase."""
    done = {}
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(
                    f"a host-tool worker exited {proc.returncode}: "
                    f"{err[-2000:]}")
            for r in json.loads(out.strip().splitlines()[-1]):
                done[r.pop("tool")] = r
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def phase_tools(tmp: str, seed: int) -> dict:
    """The spectrum tools over a cohort (phase 13 of the module
    docstring).  -> {kernel: its launches in the phase's runs on the
    card}, the counts set to 0 just before the first and read just after
    the last."""
    from findkmer_torch import spectra

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "tools")
    os.makedirs(d)
    t0 = time.perf_counter()
    samples = write_cohort(d, seed + 13)
    bases = COHORT_BASES * len(samples)
    say("tools_cohort", samples=len(samples), bases=bases,
        rates=COHORT_RATES, seconds=time.perf_counter() - t0)
    stems = [os.path.splitext(os.path.basename(p))[0] for p in samples]
    spec_dir, sk_dir = os.path.join(d, "spectra"), os.path.join(d, "sk")
    per = [os.path.join(spec_dir, f"{s}.tsv") for s in stems]
    o = {name: os.path.join(d, name) for name in (
        "matrix_k.tsv", "matrix.tsv", "merge_all.tsv", "count_all.tsv",
        "histo_k21.tsv", "histo_k8.tsv", "histo_spec21.tsv",
        "histo_spec8.tsv", "count_k8.tsv", "plain_k21.tsv", "canonized.tsv",
        "merge12.tsv", "intersect12.tsv", "counters12.tsv", "kmers12.tsv",
        "expr_sum.tsv", "expr_min.tsv", "expr_counters.tsv",
        "expr_kmers.tsv", "sorted1.tsv", "skspec")}
    os.makedirs(o["skspec"])
    counting = []

    def on_card(name: str, argv: list, n_bases: int) -> tuple:
        stats, wall = run_cli(argv + ["--device", "cuda"])
        run = {"run": name, "bases": n_bases, "wall_s": wall,
               "bases_per_s": n_bases / wall}
        say("tools_count", **run)
        counting.append(run)
        return stats, wall

    def host(name, argv, inputs):
        return (name, argv, os.path.join(d, f"{name}.stdout")), inputs

    s1, s2 = per[0], per[1]
    e12 = ["-i", f"s1={s1}", f"s2={s2}"]
    for fn in WRAPPERS.values():
        fn.launches = 0
    with _RowSortTap() as sorts, \
            _Tap(cli, "_count_inputs_to_files", lambda *a: {}) as counts_t, \
            _Tap(spectra, "matrix_sorted_streaming",
                 lambda *a: {}) as matrix_t:
        on_card("count_per_input", ["count", "-i", *samples, "--per-input",
                                    "-o", spec_dir] + COHORT_K, bases)
        on_card("sketch_per_input", ["sketch", "-i", *samples, "-s",
                                     SKETCH_S, "--per-input", "-o", sk_dir]
                + COHORT_K, bases)
        lines = {p: _lines(p) for p in per}
        with open(s1, "rb") as f:
            head = [f.readline().split(b"\t")[0].decode() for _ in range(3)]
        query = head + ["A" * 21, "acgt" * 5 + "a"]
        sketches = [os.path.join(sk_dir, f"{s}.sketch.json") for s in stems]
        # the Python streams in worker processes, three of about a minute
        # or more each; the C paths (OpenMP over every core) later in
        # this process, alone
        jobs = [
            [host("matrix", ["matrix", "-i", *per, "--min-samples", "2",
                             "-o", o["matrix.tsv"]], per)],
            [host("expr_sum", ["expr", "s1 + s2", *e12, "-o",
                               o["expr_sum.tsv"]], [s1, s2]),
             host("expr_min", ["expr", "s1 * s2", *e12, "-o",
                               o["expr_min.tsv"]], [s1, s2]),
             host("expr_counters", ["expr", "s1 ~ s2", *e12, "-o",
                                    o["expr_counters.tsv"]], [s1, s2]),
             host("expr_kmers", ["expr", "s1 - s2", *e12, "-o",
                                 o["expr_kmers.tsv"]], [s1, s2])],
            [host("diff", ["diff", "-i", s1, s2, "--limit", "5"], [s1, s2]),
             host("sort", ["sort", s1, "-o", o["sorted1.tsv"]], [s1]),
             host("topn", ["topn", s1, "-n", "10"], [s1]),
             host("query", ["query", s1, *query], [s1])],
        ]
        c_jobs = [
            host("merge12", ["merge", "-i", s1, s2, "-o", o["merge12.tsv"]],
                 [s1, s2]),
            host("intersect", ["intersect", "-i", s1, s2, "-o",
                               o["intersect12.tsv"]], [s1, s2]),
            host("subtract_counters", ["subtract", "-i", s1, s2, "-o",
                                       o["counters12.tsv"]], [s1, s2]),
            host("subtract_kmers", ["subtract", "-i", s1, s2, "--mode",
                                    "kmers", "-o", o["kmers12.tsv"]],
                 [s1, s2]),
            host("info", ["info", s1, "--json"], [s1]),
            host("histo_spec21", ["histo", "-i", s1, "-k", "21",
                                  "--from-spectrum", "-o",
                                  o["histo_spec21.tsv"]], [s1]),
            host("similarity_spectra", ["similarity", "-i", s1, s2,
                                        "--json"], [s1, s2]),
            host("merge_all", ["merge", "-i", *per, "-o", o["merge_all.tsv"]],
                 per),
            *[host(f"sketch_spectrum{i + 1}",
                   ["sketch", "-i", p, "-s", SKETCH_S, "--canonical",
                    "--name", samples[i], "-o",
                    os.path.join(o["skspec"], f"{stems[i]}.sketch.json")],
                   [p]) for i, p in enumerate(per)],
            host("similarity_sketches", ["similarity", "-i", *sketches],
                 sketches),
            host("canonize", ["canonize", o["plain_k21.tsv"], "-o",
                              o["canonized.tsv"]], [o["plain_k21.tsv"]]),
            host("histo_spec8", ["histo", "-i", o["count_k8.tsv"], "-k", "8",
                                 "--from-spectrum", "-o",
                                 o["histo_spec8.tsv"]], [o["count_k8.tsv"]]),
        ]
        inputs = {job[0]: ins for worker in jobs + [c_jobs]
                  for job, ins in worker}
        worker_tools = {job[0] for worker in jobs for job, _ in worker}
        procs = [_start_tools(d, [job for job, _ in worker])
                 for worker in jobs]
        try:
            on_card("histo_k21", ["histo", "-i", samples[0], "-o",
                                  o["histo_k21.tsv"]] + COHORT_K,
                    COHORT_BASES)
            k2_before = fused_window_histogram_cuda.launches
            on_card("histo_k8", ["histo", "-i", samples[0], "-k", "8", "-o",
                                 o["histo_k8.tsv"]], COHORT_BASES)
            on_card("count_k8", ["count", "-i", samples[0], "-k", "8", "-o",
                                 o["count_k8.tsv"]], COHORT_BASES)
            k2 = fused_window_histogram_cuda.launches - k2_before
            on_card("count_plain_k21", ["count", "-i", samples[0], "-k",
                                        "21", "-o", o["plain_k21.tsv"]],
                    COHORT_BASES)
            on_card("count_all", ["count", "-i", *samples, "-o",
                                  o["count_all.tsv"]] + COHORT_K, bases)
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                if cli.main(["stats", "-i", *samples, "-k", "21"]) != 0:
                    raise AssertionError("stats failed")
            wall = time.perf_counter() - t0
            stats = json.loads(out.getvalue())
            say("tools_stats", bases=stats["bases"], wall_s=wall,
                bases_per_s=stats["bases"] / wall)
            _, matrix_wall = on_card(
                "matrix_k", ["matrix", "-i", *samples, "--min-samples", "2",
                             "-o", o["matrix_k.tsv"]] + COHORT_K, bases)
        finally:
            host_runs = _finish_tools(procs)
        for (name, argv, stdout), _ in c_jobs:
            with open(stdout, "w") as f, contextlib.redirect_stdout(f), \
                    contextlib.redirect_stderr(io.StringIO()):
                t0 = time.perf_counter()
                rc = cli.main(argv)
                host_runs[name] = {"rc": rc,
                                   "seconds": time.perf_counter() - t0}
        launched = {name: fn.launches for name, fn in WRAPPERS.items()}
        row_sorts = sorts.calls
    say("tools_matrix_k", wall_s=matrix_wall,
        count_s=sum(c["seconds"] for c in counts_t.calls),
        matrix_s=sum(c["seconds"] for c in matrix_t.calls),
        note="count: the per-sample counts on the card and their spectrum "
             "files; matrix: the streaming k-way merge over those files")
    for name, r in host_runs.items():
        n = sum(lines[p] if p in lines else _lines(p) for p in inputs[name])
        say("tools_host", tool=name, rc=r["rc"], seconds=r["seconds"],
            input_lines=n, lines_per_s=n / r["seconds"],
            where="worker" if name in worker_tools else "alone")
    want_rc = {"diff": 1}
    bad = {n: r["rc"] for n, r in host_runs.items()
           if r["rc"] != want_rc.get(n, 0)}
    if bad:
        raise AssertionError(f"host tools exited {bad}")

    # the checks; each output is hashed, then deleted
    def sha(path: str) -> str:
        return _sha256_and_delete(path)[0]

    with open(os.path.join(d, "similarity_sketches.stdout")) as f:
        rows = f.read().splitlines()
    with open(os.path.join(d, "info.stdout")) as f:
        info = json.loads(f.read())
    with open(os.path.join(d, "query.stdout")) as f:
        answered = f.read().splitlines()
    with open(os.path.join(d, "diff.stdout")) as f:
        diff_lines = f.read().splitlines()
    s1_sha = _sha256(s1)
    checks = {
        "matrix_k == matrix over count --per-input":
            sha(o["matrix_k.tsv"]) == sha(o["matrix.tsv"]),
        "sketch -k == sketch of each spectrum": all(
            _read_and_delete(a) == _read_and_delete(os.path.join(
                o["skspec"], os.path.basename(a))) for a in sketches),
        "similarity over the sketches: 28 pairs": len(rows) == 29,
        "histo -k 21 == histo --from-spectrum":
            sha(o["histo_k21.tsv"]) == sha(o["histo_spec21.tsv"]),
        "histo -k 8 == histo --from-spectrum of count -k 8":
            sha(o["histo_k8.tsv"]) == sha(o["histo_spec8.tsv"]),
        "merge of the samples' spectra == count of the samples":
            sha(o["merge_all.tsv"]) == sha(o["count_all.tsv"]),
        "canonize of count -k 21 == count --canonical":
            sha(o["canonized.tsv"]) == s1_sha,
        "sort of a sorted spectrum == itself":
            sha(o["sorted1.tsv"]) == s1_sha,
        "expr s1 + s2 == merge":
            sha(o["expr_sum.tsv"]) == sha(o["merge12.tsv"]),
        "expr s1 * s2 == intersect":
            sha(o["expr_min.tsv"]) == sha(o["intersect12.tsv"]),
        "expr s1 ~ s2 == subtract --mode counters":
            sha(o["expr_counters.tsv"]) == sha(o["counters12.tsv"]),
        "expr s1 - s2 == subtract --mode kmers":
            sha(o["expr_kmers.tsv"]) == sha(o["kmers12.tsv"]),
        "info: sorted canonical k=21, distinct == lines": (
            info["k"] == 21 and info["sorted"] == "yes"
            and info["canonical"] == "yes"
            and info["distinct"] == lines[s1]),
        "query answers each k-mer": len(answered) == len(query) and all(
            int(a.split("\t")[1]) > 0 for a in answered[:3]),
        "diff of two samples exits 1": bool(diff_lines),
        "every row sort a K3 launch, K1 none, K2 on the k=8 runs": (
            row_sorts > 0 and launched["sort_rows_cuda"] == row_sorts
            and launched["histogram_cuda"] == 0 and k2 >= 2
            and launched["fused_window_histogram_cuda"] == k2),
    }
    failed = [c for c, ok in checks.items() if not ok]
    say("tools_checks", passed=len(checks) - len(failed), failed=failed,
        launches=launched, row_sorts=row_sorts,
        similarity_sketches=rows[:3], info=info)
    if failed:
        raise AssertionError(f"tools phase: {failed}")
    shutil.rmtree(d)
    say("tools_launches", **launched, counting_runs=len(counting),
        host_tools=len(host_runs), seconds=time.perf_counter() - t_phase)
    return launched


# phase 14: counting over a mesh of shards (parallel/), all on card 0
# two production batches of 1024 x 65536 (128 Mi bases and the record
# separators would spill into a third)
MESH_GENOME_BASES = 128_000_000
MESH_SHARDS = (2, 4)
# the spill leg's capacity: far below a shard's ~33 M distinct k=21 codes
MESH_SPILL_CAPACITY = 1 << 20
COORD_BASES = 32 << 20


def _sha256_of_cli(args, out: str) -> tuple:
    """`findkmer_torch.cli` in this process, its output's sha256 (the
    file deleted) -> (sha256, bytes, wall seconds)."""
    _, wall = run_cli(args + ["-o", out])
    digest, size = _sha256_and_delete(out)
    return digest, size, wall


def _mesh_cli(d: str, fasta: str) -> None:
    """`count --devices 0` (every card: one here, so the single engine)
    and `count --devices 2` (a mesh of two cards, or the reference's
    refusal on one card) against `count`."""
    common = ["count", "-i", fasta, "-k", "21", "--canonical", "--device",
              "cuda"]
    want, size, wall = _sha256_of_cli(common, os.path.join(d, "one.tsv"))
    got, _, wall0 = _sha256_of_cli(common + ["--devices", "0"],
                                   os.path.join(d, "all.tsv"))
    if got != want:
        raise AssertionError(f"count --devices 0: {got} != count's {want}")
    cards = torch.cuda.device_count()
    engine0 = type(counter_mod.make_counter(
        Config(k=21, devices=0), torch.device("cuda"))).__name__
    two = {"device_count": cards, "devices_0_engine": engine0,
           "sha256": want, "bytes": size, "count_s": wall,
           "devices_0_s": wall0}
    if cards < 2:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(common + ["--devices", "2", "-o",
                                    os.path.join(d, "two.tsv")])
        if rc != 2 or "need 2 devices, have 1" not in err.getvalue():
            raise AssertionError(f"count --devices 2 on one card: rc {rc}, "
                                 f"{err.getvalue()!r}")
        two["devices_2"] = err.getvalue().strip()
    else:
        got2, _, wall2 = _sha256_of_cli(common + ["--devices", "2"],
                                        os.path.join(d, "two.tsv"))
        if got2 != want:
            raise AssertionError(f"count --devices 2: {got2} != {want}")
        two["devices_2_s"] = wall2
    say("mesh_cli", **two)


def _coordinator_group(d: str, fasta: str) -> None:
    """Two `stream --coordinator` processes on this card, one gloo group
    on localhost: process 0 writes the full spectrum, sha256-equal to one
    process's `count`; process 1 writes nothing."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    flags = ["-k", "21", "--canonical", "--device", "cuda"]
    outs = [os.path.join(d, f"h{i}.tsv") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO,
               FINDKMER_COORDINATOR_TIMEOUT="120")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "findkmer_torch.cli", "stream", "-i", fasta,
         *flags, "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         "2", "--process-id", str(i), "-o", outs[i], "--stats", "json"],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise AssertionError(f"coordinator group: rc {p.returncode}: "
                                 f"{err[-2000:]}")
    if os.path.exists(outs[1]):
        raise AssertionError("coordinator group: process 1 wrote a file")
    got, size = _sha256_and_delete(outs[0])
    want, _, count_s = _sha256_of_cli(["count", "-i", fasta, *flags],
                                      os.path.join(d, "one.tsv"))
    if got != want:
        raise AssertionError(f"coordinator group: {got} != count's {want}")
    phases = [json.loads([ln for ln in err.splitlines()
                          if ln.startswith("{")][-1])["phases"]
              for err in errs]
    say("mesh_coordinator", processes=2, bases=COORD_BASES, wall_s=wall,
        count_s=count_s, sha256=got, bytes=size,
        collective_merge_s=[ph.get("collective_merge", {}).get("total_s")
                            for ph in phases])


def _profile_trace(d: str, fasta: str) -> None:
    """`count -k 8 --profile DIR`: the Chrome trace exists and names K2's
    kernel (window_hist) among its device events."""
    trace_dir = os.path.join(d, "trace")
    digest, _, wall = _sha256_of_cli(
        ["count", "-i", fasta, "-k", "8", "--device", "cuda", "--profile",
         trace_dir], os.path.join(d, "k8.tsv"))
    want, _, _ = _sha256_of_cli(["count", "-i", fasta, "-k", "8",
                                 "--device", "cuda"],
                                os.path.join(d, "k8.tsv"))
    names = os.listdir(trace_dir)
    if digest != want or len(names) != 1:
        raise AssertionError(f"--profile: {names}, {digest} vs {want}")
    with open(os.path.join(trace_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = collections.Counter(
        e["name"][:120] for e in events if e.get("cat") == "kernel")
    k2 = sum(c for name, c in kernels.items() if "window_hist" in name)
    if k2 == 0:
        raise AssertionError(f"--profile trace names no K2 kernel: "
                             f"{kernels.most_common(8)}")
    say("mesh_profile", trace=names[0], trace_bytes=os.path.getsize(
        os.path.join(trace_dir, names[0])), events=len(events),
        window_hist_events=k2, kernels=dict(kernels.most_common(8)),
        wall_s=wall)
    shutil.rmtree(trace_dir)


def phase_mesh(tmp: str, seed: int) -> dict:
    """Counting over a mesh (phase 14 of the module docstring).  -> {kernel:
    its launches in the mesh runs of the dry run}, the counts set to 0
    just before the first and read just after the last."""
    from findkmer_torch.parallel import dryrun

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "mesh")
    os.makedirs(d)
    fasta = os.path.join(d, "genome.fa")
    write_genome(fasta, seed + 14, MESH_GENOME_BASES)
    dev = torch.device("cuda", 0)
    # the capacity: a shard (and the single reference) holds all ~129 M
    # distinct canonical 21-mers; the spill leg sets its own
    run = dryrun.DryRun(
        fasta, Config(batch_rows=PROD_SHAPE[0], chunk_len=PROD_SHAPE[1],
                      sparse_capacity=1 << 28),
        reference="engine", device=dev, k_dense=8, k_route=15, k_scaled=15,
        k_sparse=21, spill_capacity=MESH_SPILL_CAPACITY)
    t0 = time.perf_counter()
    run.prepare()
    torch.cuda.empty_cache()
    say("mesh_references", bases=MESH_GENOME_BASES,
        seconds=time.perf_counter() - t0,
        batches=len(run.batches(run.leg_config("psum", 2))))
    legs = []
    with _RowSortTap() as tap:
        for w in WRAPPERS.values():
            w.launches = 0
        for n in MESH_SHARDS:
            mesh = [dev] * n
            # the checkpoint leg: written at 4 shards, restored at 2; and
            # written at 2, restored on the single engine
            recs = run.run(mesh, restore_mesh=mesh[: max(n // 2, 1)],
                           report=lambda rec: say("mesh_leg", **rec))
            legs.extend(recs.values())
            torch.cuda.empty_cache()
        launched = {name: w.launches for name, w in WRAPPERS.items()}
        sorts = tap.calls
    # the spill leg dedups its shards' stores as long rows
    if (launched["fused_window_histogram_cuda"] == 0 or sorts == 0
            or launched["sort_rows_cuda"] != sorts
            or not launched["sort_rows_cuda_long"]):
        raise AssertionError(f"mesh phase: launches {launched} for {sorts} "
                             "row sorts")
    say("mesh_launches", **launched, row_sorts=sorts)
    say("mesh_steps", by_leg={
        f"{r['leg']}@{r['shards']}": {
            "step_ms": r["step_ms"],
            "single_device_step_ms": r["reference_step_ms"],
            "finalize_s": r.get("finalize_s")} for r in legs})
    del run
    torch.cuda.empty_cache()
    coord = os.path.join(d, "coord.fa")
    write_genome(coord, seed + 15, COORD_BASES)
    os.unlink(fasta)
    _mesh_cli(d, coord)
    _coordinator_group(d, coord)
    _profile_trace(d, coord)
    shutil.rmtree(d)
    say("mesh_phase", seconds=time.perf_counter() - t_phase)
    return launched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also time the FASTA reader alone and profile the "
                         "device step by kernel")
    ap.add_argument("--only", choices=["rowsort", "window", "stream",
                                       "filter", "tools", "mesh", "spill",
                                       "installed"],
                    help="run only the row sort's phases (K3), only the "
                         "histogram kernels' (K1 and K2), only the "
                         "restartable stream's, only read filtering's, "
                         "only the spectrum tools', only the mesh's, only "
                         "the `count --spill` A/B (--against), or only the "
                         "installed package's, and stop: no summary, no "
                         "ok-line; the quick check of an edit")
    ap.add_argument("--against", metavar="DIR",
                    help="with --only spill: another checkout of the port "
                         "(e.g. the parent commit) whose `count --spill` "
                         "runs in turn with this one's")
    args = ap.parse_args()

    smi = phase_environment()
    phase_build()
    if args.only == "rowsort":
        phase_ptxas("rowsort.cu")
        phase_sass()
        phase_rowsort_vs_plain(args.seed)
        phase_rowsort_timing(args.seed)
        return 0
    if args.only == "stream":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_stream(tmp, args.seed)
        return 0
    if args.only == "filter":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_filter(tmp, args.seed)
        return 0
    if args.only == "tools":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_tools(tmp, args.seed)
        return 0
    if args.only == "mesh":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_mesh(tmp, args.seed)
        return 0
    if args.only == "spill":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_spill_ab(tmp, args.seed, args.against)
        return 0
    if args.only == "installed":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            fasta = phase_genome(tmp, args.seed)
            phase_installed(tmp, fasta, checkout_counts(tmp, fasta), smi)
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
        sort_launches, long_launches, sparse_runs = phase_sparse_main_path(
            tmp, fasta)
        phase_sparse_device_step(fasta)
        dense8 = next(r for r in runs if r["k"] == 8 and not r["args"]
                      and r["route"] == "fused")
        sparse21 = next(r for r in sparse_runs if r["k"] == 21
                        and r["row_sort"] == "auto")
        installed_launches = phase_installed(tmp, fasta, {
            "k8": {"sha256": dense8["sha256"], "launches": {
                "histogram_cuda": dense8["k1_launches"],
                "fused_window_histogram_cuda": dense8["k2_launches"],
                "sort_rows_cuda": 0, "sort_rows_cuda_long": 0}},
            "k21_canonical": {"sha256": sparse21["sha256"], "launches": {
                "histogram_cuda": 0, "fused_window_histogram_cuda": 0,
                "sort_rows_cuda": sparse21["launches"],
                "sort_rows_cuda_long": 0}}}, smi)
        os.unlink(fasta)
        phase_oracle(tmp)
        stream_launches = phase_stream(tmp, args.seed)
        phase_entry_points(tmp, args.seed)
        filter_launches = phase_filter(tmp, args.seed)
        tools_launches = phase_tools(tmp, args.seed)
        mesh_launches = phase_mesh(tmp, args.seed)
    t8 = timing[f"k8_valid{TIMED_VALID[-1]}"]
    w8 = k2_timing["k8"]
    raw21 = sort_timing["raw_k21"]

    def ms_of(case: dict) -> dict:
        return {name: t["ms"] for name, t in case.items() if "ms" in t}

    def bound_of(b: dict) -> dict:
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}

    def launches_of(name: str, count: int) -> dict:
        """The `count` paths' launches, each stream-phase run's own, the
        filter runs' (none), the spectrum tools' (K2 and K3), the mesh's
        (K2 and K3) and the installed package's (K2 and K3)."""
        by_run = {**stream_launches[name], "filter": filter_launches[name],
                  "tools": tools_launches[name],
                  "mesh": mesh_launches[name],
                  "installed": installed_launches[name]}
        return {"launches": count + sum(by_run.values()),
                "launches_by_path": {"count": count, **by_run}}

    print(json.dumps({"kernels": [{
        "name": "histogram_cuda",
        "route": "cuda",
        "source": "findkmer_torch/csrc/histogram.cu",
        "replaces": "findkmer_tpu/ops/pallas/histogram_kernel.py:125",
        **launches_of("histogram_cuda", launches),
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
        **launches_of("fused_window_histogram_cuda", k2_launches),
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
        **launches_of("sort_rows_cuda", sort_launches),
        # of them on rows longer than a tile: the merge passes
        **{f"long_{key}": v for key, v in launches_of(
            "sort_rows_cuda_long", long_launches).items()},
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
