"""findkmer-torch CLI: the port's subcommands.

    python -m findkmer_torch.cli count -i in.fa -k 21 -o out.tsv [--device cuda]
    python -m findkmer_torch.cli count -i a.fa b.fa -k 8 --per-input -o DIR
    python -m findkmer_torch.cli count -i reads.fq -k 8 --per-record
    python -m findkmer_torch.cli count -i in.fa -k 21 -o out.tsv --spill DIR
    python -m findkmer_torch.cli stream -i in.fa -k 21 -o out.tsv \
        --checkpoint DIR [--checkpoint-every N] [--spill DIR]
    python -m findkmer_torch.cli filter -i reads.fq --spectrum spec.tsv \
        -o kept.fq [--engine auto|host|device] [--device cuda]
    python -m findkmer_torch.cli filter -i R1.fq R2.fq --paired \
        --spectrum spec.tsv -o kept1.fq,kept2.fq
    python -m findkmer_torch.cli selftest [--device cuda] [--seed N]

Counted on --device (cuda by default) before their host work:
    python -m findkmer_torch.cli matrix -i a.fa b.fa -k 21 --canonical -o m.tsv
    python -m findkmer_torch.cli sketch -i a.fa b.fa -k 21 --per-input -o DIR
    python -m findkmer_torch.cli histo -i in.fa -k 21 [--from-spectrum]

Host only, over spectrum (or sketch) files, no --device:
    stats (the host batcher alone), merge, matrix (without -k), expr,
    intersect, subtract, sort, canonize, query, topn, info, similarity,
    sketch (without -k), diff (exit 1 when the spectra differ)

Same arguments (flags, defaults, help texts, exit codes) and the same
output bytes as the same subcommands of the JAX package's `findkmer`
(whose checkpoints, spill runs and sketches the port reads, and the other
way round): `_add_common`, `_cfg_from_args` with its sparse autosize,
`_open_out`, the input stems of --per-input and `matrix`, and the
commands themselves are the port's own copies of that CLI's, over the
port's `spectra.py` and `sketch.py`; the spectrum is written by
`findkmer_torch.output` (`write_spectrum` and, for sparse tables,
`write_spectrum_streaming` over the counter's chunked finalize).  Any k
up to 31 counts; the spectrum tools also take files of longer k-mers.
`--device` picks the torch device; asking for cuda without one is an
error (exit 2), never a CPU run.  One exit code differs: `filter` refuses
SAM/BAM input with exit 2 (trouble), where the JAX CLI exits 1 (its
"nothing kept").  `bench` is not ported.

Not yet ported, each refused with one error line and exit 2: `--devices`
other than 1 and `--profile` (`count`, `stream`, `histo`), and `stream
--coordinator` with more than one process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from findkmer_torch.config import Config


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("-i", "--input", required=True, nargs="+",
                   help="FASTA/FASTQ/SAM/BAM file(s), optionally gzipped "
                        "('-' = stdin)")
    p.add_argument("--format", choices=["auto", "fasta", "fastq", "sam",
                                        "bam"],
                   default="auto", help="input format (auto-sniffed)")
    p.add_argument("--min-qual", type=int, default=0, metavar="N",
                   help="mask bases with phred quality < N to 'N' "
                        "(FASTQ/SAM/BAM inputs; 0 = off)")
    p.add_argument("--qual-offset", type=int, default=33,
                   help="ASCII phred offset for FASTQ/SAM qualities "
                        "(default 33; BAM is raw phred)")
    p.add_argument("-k", type=int, required=True, help="k-mer length (1..31)")
    p.add_argument("-o", "--output", default="-", help="output path ('-' = stdout)")
    p.add_argument("-z", "--zeros", action="store_true",
                   help="emit zero-count k-mers (direct tables only)")
    p.add_argument("--canonical", action="store_true",
                   help="count canonical (revcomp-min) k-mers")
    p.add_argument("--table-mode", choices=["auto", "direct", "sparse"],
                   default="auto")
    p.add_argument("--hist", choices=["auto", "scatter", "sort", "onehot",
                                      "pallas"], default="auto")
    p.add_argument("--batch-rows", type=int, default=256)
    p.add_argument("--chunk-len", type=int, default=65536)
    p.add_argument("--sparse-capacity", type=int, default=1 << 22)
    p.add_argument("--sparse-compact-entries", type=int, default=1 << 28,
                   help="buffered raw window codes between store "
                        "compactions (the spill check runs per "
                        "compaction)")
    p.add_argument("--spill", default="", metavar="DIR",
                   help="disk-spill directory (sparse tables): crossing "
                        "--sparse-capacity distinct k-mers spills sorted "
                        "runs to DIR instead of erroring; finalize "
                        "streams a k-way merge — HBM-bounded counting "
                        "for spectra larger than device memory.  DIR "
                        "must be empty; consumed run files are deleted "
                        "after a successful finalize")
    p.add_argument("--count-dtype", choices=["int32", "int64"],
                   default="int32",
                   help="count dtype (int64 for >2^31 observations of a "
                        "single k-mer; enables 64-bit mode)")
    p.add_argument("--devices", type=int, default=1,
                   help="devices in the counting mesh (1 = single-device "
                        "engine, 0 = all available, N = first N)")
    p.add_argument("--merge", choices=["auto", "psum", "psum_scatter",
                                       "all_to_all"], default="auto",
                   help="multi-device table merge strategy")
    p.add_argument("--sep", default="\t")
    p.add_argument("--counts-only", action="store_true")
    p.add_argument("--no-native-encode", action="store_true")
    p.add_argument("--stats", choices=["none", "json"], default="none",
                   help="print stream statistics to stderr")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="emit a jax.profiler trace to LOGDIR")
    p.add_argument("--log", default=None, help="log level (DEBUG/INFO/...)")


def _cfg_from_args(args):
    cfg = Config(
        k=args.k,
        canonical=args.canonical,
        table_mode=args.table_mode,
        hist=args.hist,
        batch_rows=args.batch_rows,
        chunk_len=max(args.chunk_len, args.k),
        sparse_capacity=args.sparse_capacity,
        sparse_compact_entries=getattr(args, "sparse_compact_entries",
                                       1 << 28),
        spill_dir=getattr(args, "spill", ""),
        count_dtype=args.count_dtype,
        devices=args.devices,
        merge=args.merge,
        input_format=args.format,
        min_qual=getattr(args, "min_qual", 0),
        qual_offset=getattr(args, "qual_offset", 33),
        zeros=args.zeros,
        sep=args.sep,
        out_counts_only=args.counts_only,
        min_count=getattr(args, "min_count", 0),
        max_count=getattr(args, "max_count", 0),
        use_native_encode=not args.no_native_encode,
    )
    # fail fast, before any counting happens
    cfg.resolved_table_mode
    if cfg.zeros and cfg.resolved_table_mode != "direct":
        hint = (
            " (pass --table-mode direct to force a dense 4^k table; "
            "valid up to k=15)"
            if cfg.table_mode == "auto" and cfg.k <= 15
            else ""
        )
        raise ValueError(
            "-z/--zeros requires a direct (dense) table; "
            f"k={cfg.k} resolves to a sparse table{hint}"
        )
    return _autosize_sparse(
        cfg, getattr(args, "input", []) or [],
        user_set_capacity=args.sparse_capacity != 1 << 22,
    )


def _autosize_sparse(cfg, inputs, user_set_capacity: bool):
    """Size the sparse store and raw buffer from the input files.

    Auto-size the sparse store when the user left it at the default:
    distinct k-mers <= windows <= input bytes; clamp to a ceiling that
    leaves device memory for the store and its flush working set.
    Explicit --sparse-capacity always wins; a store overflow still
    errors with a clear message.  The raw code buffer is pre-sized from
    input size so the engine allocates once instead of growing through
    the shape ladder."""
    total_bytes = 0
    for path in inputs:
        if path == "-":
            continue  # stdin: size unknown, nothing to stat
        if not os.path.exists(path):
            raise FileNotFoundError(f"input file not found: {path}")
        total_bytes += os.path.getsize(path)
    if (
        cfg.resolved_table_mode == "sparse"
        and not user_set_capacity
        and total_bytes > 0
    ):
        need = min(total_bytes, min(4 ** cfg.k, 1 << 28))
        cap = 1 << 20
        while cap < need:
            cap <<= 1
        if cap != cfg.sparse_capacity:
            cfg = cfg.replace(sparse_capacity=cap)
    if cfg.resolved_table_mode == "sparse" and total_bytes > 0:
        cfg = cfg.replace(sparse_expected_entries=total_bytes)
    return cfg


def _open_out(path):
    if path == "-":
        return sys.stdout.buffer, False
    if path.endswith(".gz"):
        # gzip-compressed output by extension (mirrors gzip input);
        # bypasses the O_DIRECT writer: compressed bytes are a
        # fraction of the spectrum, so the page-dirty cost is too
        import gzip

        return gzip.open(path, "wb", compresslevel=4), True
    if os.environ.get("FINDKMER_DIRECT_OUT", "1") == "1":
        # O_DIRECT writer (utils/directio.py): skips dirtying fresh
        # page-cache pages; falls back to buffered automatically
        try:
            from findkmer_torch.utils.directio import DirectWriter

            return DirectWriter(path), True
        except Exception:
            pass
    return open(path, "wb"), True


_SEQ_EXTS = (".fa", ".fasta", ".fna", ".fq", ".fastq", ".txt")


def _input_stem(path: str, seen: dict, exts=_SEQ_EXTS) -> str:
    """Display stem of an input: basename, one (case-insensitive)
    known extension stripped after any .gz, de-collided with .2/.3/...
    (the naming convention of --per-input)."""
    base = os.path.basename(path)
    if base.endswith(".gz"):
        base = base[:-3]
    root, ext = os.path.splitext(base)
    if ext.lower() in exts:
        base = root
    n = seen.get(base, 0) + 1
    seen[base] = n
    return base if n == 1 else f"{base}.{n}"


def _per_input_name(path: str, seen: dict) -> str:
    """Output filename for --per-input: input stem + '.tsv'."""
    return _input_stem(path, seen) + ".tsv"


def _refuse_unported(args, cfg) -> None:
    where = "ROADMAP.md Queue 1"
    unported = [
        (args.devices != 1, f"--devices {args.devices}", f"{where} item 13"),
        (args.profile is not None, "--profile", f"{where} item 12"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not yet ported to findkmer_torch ({item})"
            )


def _use_streamed_finalize(counter) -> bool:
    """Sparse runs stream the write per finalize chunk
    (counter.finalize_chunks: the ordered finalize, or the spill merge).
    FINDKMER_ORDERED_FINALIZE=0 turns this off too, so that the heap-merge
    finalize is reachable from the CLI."""
    if os.environ.get("FINDKMER_ORDERED_FINALIZE", "1") != "1":
        return False
    return counter.mode != "direct"


def emit_streamed_spectrum(counter, state, cfg, output, timers=None):
    """Open `output` and write counter.finalize_chunks(state) to it: the
    shared streamed-finalize tail of `count` and `stream`.  Each chunk is
    formatted and written while the next one's device-to-host copy is in
    flight."""
    from findkmer_torch import output as output_mod

    f, close = _open_out(output)
    try:
        chunks = counter.finalize_chunks(state, timers=timers)
        if timers is not None:
            chunks = _timed_chunks(chunks, timers)
        output_mod.write_spectrum_streaming(f, chunks, cfg)
    finally:
        if close:
            f.close()


def _warn_numpy_encoder(cfg) -> str:
    """-> the host encoder that will run ("native" or "numpy"), with one
    warning line where the C one was asked for and could not be built."""
    from findkmer_torch import pipeline

    encoder = pipeline.host_encoder(cfg.use_native_encode)
    if encoder == "numpy" and cfg.use_native_encode:
        print("findkmer-torch: warning: the C host encoder "
              "(findkmer_torch/io/native.py) could not be built with $CC or "
              "cc; counting with its numpy fallback (same output, slower "
              "host path)", file=sys.stderr)
    return encoder


def _set_log_level(level) -> None:
    """--log LEVEL: the level of the "findkmer" logger, through the
    variable that `utils.logging.get_logger` reads at its first call, and
    on the logger itself where an earlier import has configured it."""
    if level:
        import logging

        logging.getLogger("findkmer").setLevel(level.upper())
        os.environ["FINDKMER_LOGLEVEL"] = level


def _timed_chunks(chunks, timers):
    """Pass finalize chunks through, timing the wait for each chunk as
    "finalize" and the caller's work on it (format, write) as "write"."""
    it = iter(chunks)
    while True:
        with timers.phase("finalize"):
            chunk = next(it, None)
        if chunk is None:
            return
        with timers.phase("write"):
            yield chunk


def _count_inputs_to_files(inputs, out_paths, cfg, device, stats=None,
                           row_sort: str = "auto",
                           dense_kernel: str = "fused") -> None:
    """Count each input on its own on `device` into its spectrum file
    (count --per-input and matrix -k share this loop); row_sort and
    dense_kernel pick the counter's kernels, as in `cmd_count`."""
    from findkmer_torch import output as output_mod
    from findkmer_torch import pipeline

    for path, out in zip(inputs, out_paths):
        spectrum = pipeline.count_file(path, cfg, device, stats=stats,
                                       row_sort=row_sort,
                                       dense_kernel=dense_kernel)
        with open(out, "wb") as f:
            output_mod.write_spectrum(f, spectrum, cfg)


def _count_per_input(args, cfg, device, kernels: dict) -> int:
    """--per-input: one spectrum file per input, written into -o DIR
    (files named <input stem>.tsv, a repeated stem as <stem>.2.tsv)."""
    from findkmer_torch import pipeline

    if args.output == "-" or (
        os.path.exists(args.output) and not os.path.isdir(args.output)
    ):
        raise ValueError("--per-input writes one file per input: "
                         "-o must name a directory")
    os.makedirs(args.output, exist_ok=True)
    stats = pipeline.StreamStats()
    seen: dict = {}
    outs = [os.path.join(args.output, _per_input_name(p, seen))
            for p in args.input]
    _count_inputs_to_files(args.input, outs, cfg, device, stats=stats,
                           **kernels)
    if args.stats == "json":
        print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def _count_per_record(args, cfg, device, kernels: dict) -> int:
    """--per-record: sectioned output, a '>header' line, then that
    record's spectrum (one section per FASTA record / FASTQ read)."""
    from findkmer_torch import output as output_mod
    from findkmer_torch import pipeline

    stats = pipeline.StreamStats()
    f, close = _open_out(args.output)
    try:
        for path in args.input:
            for header, spectrum in pipeline.per_record_spectra(
                path, cfg, device, stats=stats, **kernels
            ):
                f.write(b">" + header.encode("ascii", "replace") + b"\n")
                output_mod.write_spectrum(f, spectrum, cfg)
    finally:
        if close:
            f.close()
    if args.stats == "json":
        print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def cmd_count(args, row_sort: str = "auto",
              dense_kernel: str = "fused") -> int:
    """`count`.  row_sort and dense_kernel pick the counter's kernels for
    callers in Python (`KmerCounter`: the sparse store's row sort "auto",
    "kernel" or "plain"; the dense step "fused" or "two_stage"); they are
    no flags."""
    import torch

    from findkmer_torch import output as output_mod
    from findkmer_torch import pipeline
    from findkmer_torch.device import resolve_device
    from findkmer_torch.utils.prof import PhaseTimers

    _set_log_level(args.log)
    cfg = _cfg_from_args(args)
    if args.per_input and args.per_record:
        raise ValueError("--per-input and --per-record are exclusive")
    if cfg.spill_dir and (args.per_input or args.per_record):
        raise ValueError("--spill is for one combined spectrum; it does "
                         "not compose with --per-input/--per-record")
    _refuse_unported(args, cfg)
    device = resolve_device(args.device)
    encoder = _warn_numpy_encoder(cfg)
    kernels = dict(row_sort=row_sort, dense_kernel=dense_kernel)
    if args.per_input:
        return _count_per_input(args, cfg, device, kernels)
    if args.per_record:
        return _count_per_record(args, cfg, device, kernels)
    stats = pipeline.StreamStats()
    timers = PhaseTimers() if args.stats == "json" else None

    t0 = time.time()
    # multiple inputs: one combined spectrum (records concatenated)
    counter, state = pipeline.run_count(args.input, cfg, device,
                                        stats=stats, timers=timers,
                                        **kernels)
    if _use_streamed_finalize(counter):
        emit_streamed_spectrum(counter, state, cfg, args.output,
                               timers=timers)
    else:
        # dense, or the heap-merge finalize of a sparse table
        f, close = _open_out(args.output)
        try:
            if timers is None:
                output_mod.write_spectrum(f, counter.finalize(state), cfg)
            else:
                with timers.phase("finalize"):
                    spectrum = counter.finalize(state, timers=timers)
                with timers.phase("write"):
                    output_mod.write_spectrum(f, spectrum, cfg)
        finally:
            if close:
                f.close()
    wall = time.time() - t0
    if args.stats == "json":
        d = stats.as_dict()
        d["wall_s"] = wall
        d["bases_per_s"] = stats.bases / wall if wall > 0 else None
        d["device"] = (
            torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu"
        )
        d["host_encoder"] = encoder
        if timers is not None:
            d["phases"] = timers.as_dict()
        print(json.dumps(d), file=sys.stderr)
    return 0


def cmd_stream(args, row_sort: str = "auto",
               dense_kernel: str = "fused") -> int:
    """`stream` (streaming.py); row_sort and dense_kernel as in
    `cmd_count`."""
    from findkmer_torch import streaming

    _set_log_level(args.log)
    return streaming.run_stream(args, row_sort=row_sort,
                                dense_kernel=dense_kernel)


def cmd_filter(args, **_kernels) -> int:
    """Keep/drop reads by spectrum membership (kmc_tools filter class).
    The device engine scores on --device; a CUDA device that is not there
    is an error before any output is opened."""
    from findkmer_torch.device import resolve_device
    from findkmer_torch.filter import FilterSpec, _resolve_engine

    for path in args.input:  # before the output is created/truncated
        if not os.path.exists(path):
            raise FileNotFoundError(f"input file not found: {path}")
    engine = _resolve_engine(args.engine, args.device)
    device = resolve_device(args.device) if engine == "device" else None
    spec = FilterSpec.load(
        args.spectrum, sep=args.sep, canonical=args.canonical,
        min_count=args.min_count, max_count=args.max_count,
    )
    opts = dict(fmt=args.format, min_hits=args.min_hits,
                min_frac=args.min_frac, invert=args.invert, engine=engine,
                device=device, pair_mode=args.pair_mode)
    if args.paired:
        if len(args.input) != 2:
            raise ValueError(
                "--paired takes exactly two inputs (R1 R2), got "
                f"{len(args.input)}"
            )
        outs = (args.output or "").split(",")
        if len(outs) != 2 or not all(outs) or "-" in outs:
            raise ValueError(
                "--paired writes two files: -o OUT_R1,OUT_R2"
            )
        kept, seen = filter_into(args.input, outs, spec, paired=True, **opts)
        print(f"kept {kept}/{seen} read pairs (k={spec.k})",
              file=sys.stderr)
    else:
        kept, seen = filter_into(args.input, [args.output], spec, **opts)
        print(f"kept {kept}/{seen} reads (k={spec.k})", file=sys.stderr)
    return 0 if kept else 1  # grep convention: 1 = nothing kept


def filter_into(inputs, outputs, spec, *, paired: bool = False,
                pair_mode: str = "any", **opts):
    """Open `outputs` with `_open_out` (gzip when a path ends in .gz) and
    filter `inputs` into them: single-end, every input in turn into the
    one output; paired, (R1, R2) into (OUT1, OUT2).  -> (kept, seen) reads
    or pairs.  The shared tail of `cmd_filter` and `api.filter_reads`."""
    from findkmer_torch.filter import filter_file, filter_file_paired

    opened = []
    try:
        for out in outputs:
            opened.append(_open_out(out))
        if paired:
            (f1, _), (f2, _) = opened
            return filter_file_paired(inputs[0], inputs[1], f1, f2, spec,
                                      pair_mode=pair_mode, **opts)
        kept = seen = 0
        for path in inputs:
            k1, s1 = filter_file(path, opened[0][0], spec, **opts)
            kept += k1
            seen += s1
        return kept, seen
    finally:
        for f, close in opened:
            if close:
                f.close()


def cmd_stats(args, **_kernels) -> int:
    from findkmer_torch import pipeline

    cfg = _cfg_from_args(args)
    stats = pipeline.StreamStats()
    for path in args.input:
        for _ in pipeline.batches_from_file(path, cfg, stats=stats):
            pass
    print(json.dumps(stats.as_dict()))
    return 0


def cmd_merge(args, **_kernels) -> int:
    from findkmer_torch import spectra

    if args.zeros and args.k <= 0:
        raise ValueError("merge -z needs -k to enumerate all 4^k k-mers")
    if args.canonical and not args.zeros:
        raise ValueError(
            "merge --canonical only affects -z interleaving (a plain "
            "merge of canonical spectra needs no flag)"
        )
    zk = args.k if args.zeros else None
    f, close = _open_out(args.output)
    try:
        if args.in_memory:
            counts = spectra.merge_spectra(args.input, sep=args.sep,
                                           op=args.op)
            for line in spectra.spectrum_lines(counts, sep=args.sep,
                                               zeros_k=zk,
                                               canonical=args.canonical):
                f.write(line.encode() + b"\n")
        elif zk is None and args.op == "sum" and spectra.merge_binary_fast(
            args.input, f, sep=args.sep
        ):
            pass  # C fast path: parse + parallel heap merge + format
        else:
            # streaming k-way merge: O(MB) memory at chr scale (our
            # spectrum writers always emit sorted files)
            spectra.merge_sorted_streaming(args.input, f, sep=args.sep,
                                           zeros_k=zk,
                                           canonical=args.canonical,
                                           op=args.op)
    finally:
        if close:
            f.close()
    return 0


def _input_stems(paths) -> list:
    """Column names for matrix: the --per-input stem convention plus
    spectrum/alignment extensions."""
    seen: dict = {}
    exts = _SEQ_EXTS + (".tsv", ".sam", ".bam")
    return [_input_stem(p, seen, exts) for p in paths]


def cmd_matrix(args, **kernels) -> int:
    """k-mer x sample count matrix (kmtricks-class aggregation).  With -k
    each input is counted on --device into a temporary spectrum first."""
    import shutil
    import tempfile

    from findkmer_torch import spectra

    inputs = list(args.input)
    if args.names:
        names = args.names.split(",")
    else:
        names = _input_stems(inputs)
    if len(names) != len(inputs):
        # validate BEFORE _open_out truncates an existing output
        raise ValueError(
            f"matrix needs one name per input ({len(inputs)} "
            f"inputs, {len(names)} names)"
        )
    tmpdir = None
    try:
        if args.k > 0:
            # sequence inputs: count each at k into a temp spectrum
            # (one sample per input, like count --per-input), then
            # stream the matrix over the temp files
            from findkmer_torch.device import resolve_device

            device = resolve_device(args.device)
            cfg = _autosize_sparse(
                Config(k=args.k, canonical=args.canonical,
                       sep=args.sep),
                inputs, user_set_capacity=False,
            )
            tmpdir = tempfile.mkdtemp(prefix="fk-matrix-")
            counted = [os.path.join(tmpdir, f"s{i:05d}.tsv")
                       for i in range(len(inputs))]
            _count_inputs_to_files(inputs, counted, cfg, device, **kernels)
            inputs = counted
        elif args.canonical:
            raise ValueError(
                "matrix --canonical needs -k (sequence inputs); "
                "canonize spectrum files first"
            )
        f, close = _open_out(args.output)
        try:
            rows = spectra.matrix_sorted_streaming(
                inputs, f, names, sep=args.sep,
                min_total=args.min_total, min_samples=args.min_samples,
            )
        finally:
            if close:
                f.close()
    finally:
        if tmpdir:
            shutil.rmtree(tmpdir, ignore_errors=True)
    print(f"{rows} k-mers x {len(names)} samples", file=sys.stderr)
    return 0


def cmd_expr(args, **_kernels) -> int:
    """Set-algebra expression over spectra (kmc_tools `complex`)."""
    from findkmer_torch import spectra

    inputs = {}
    for spec in args.input:
        name, eq, path = spec.partition("=")
        if not eq or not name or not path:
            raise ValueError(
                f"expr inputs are NAME=PATH, got {spec!r}"
            )
        if name in inputs:
            raise ValueError(f"duplicate expr input name {name!r}")
        if not os.path.exists(path):
            raise FileNotFoundError(f"input file not found: {path}")
        inputs[name] = path
    # parse errors surface BEFORE the output is created/truncated
    spectra.eval_expression(args.expression, inputs, sep=args.sep)
    f, close = _open_out(args.output)
    try:
        n = spectra.expr_sorted_streaming(
            args.expression, inputs, f, sep=args.sep,
            canonical=args.canonical,
        )
    finally:
        if close:
            f.close()
    print(f"{n} k-mers", file=sys.stderr)
    return 0


def cmd_setop(args, **_kernels) -> int:
    """intersect / subtract (kmc_tools-style streaming set ops)."""
    from findkmer_torch import spectra

    f, close = _open_out(args.output)
    try:
        if args.cmd == "intersect":
            spectra.intersect_sorted_streaming(args.input, f, sep=args.sep,
                                               canonical=args.canonical)
        else:
            spectra.subtract_sorted_streaming(args.input, f, sep=args.sep,
                                              canonical=args.canonical,
                                              mode=args.mode)
    finally:
        if close:
            f.close()
    return 0


def cmd_sort(args, **_kernels) -> int:
    """Normalize a spectrum file: lexicographic order, case-folded,
    duplicate k-mers summed (prep for the streaming set ops)."""
    from findkmer_torch import spectra

    f, close = _open_out(args.output)
    try:
        spectra.sort_spectrum_file(
            args.input, f, sep=args.sep,
            min_count=args.min_count, max_count=args.max_count,
            set_count=args.set_count, kmers_only=args.kmers_only,
        )
    finally:
        if close:
            f.close()
    return 0


def cmd_canonize(args, **_kernels) -> int:
    """Fold a plain spectrum to canonical (revcomp-min) form."""
    from findkmer_torch import spectra

    f, close = _open_out(args.output)
    try:
        spectra.canonize_spectrum_file(args.input, f, sep=args.sep)
    finally:
        if close:
            f.close()
    return 0


def cmd_query(args, **_kernels) -> int:
    from findkmer_torch import spectra

    kmers = list(args.kmers)
    if args.kmers_file:
        f = (sys.stdin if args.kmers_file == "-"
             else open(args.kmers_file))
        try:
            kmers.extend(w for line in f for w in line.split())
        finally:
            if f is not sys.stdin:
                f.close()
    if not kmers:
        raise ValueError("no k-mers given (positional or --kmers-file)")
    counts = spectra.query_spectrum(args.spectrum, kmers,
                                    sep=args.sep,
                                    canonical=args.canonical)
    for kmer in kmers:
        print(f"{kmer.upper()}{args.sep}{counts[kmer.upper()]}")
    return 0


def cmd_topn(args, **_kernels) -> int:
    from findkmer_torch import spectra

    for kmer, cnt in spectra.top_n(args.spectrum, args.n, sep=args.sep):
        print(f"{kmer}{args.sep}{cnt}")
    return 0


def _emit_kv(d, as_json: bool) -> None:
    if as_json:
        print(json.dumps(d))
        return
    for key, val in d.items():
        if isinstance(val, float):
            val = f"{val:.6g}"
        print(f"{key}\t{val}")


def cmd_info(args, **_kernels) -> int:
    """Summary statistics of a spectrum file (kmc_tools info analog),
    or of a sketch file (format/name/k/s/canonical/n_hashes)."""
    from findkmer_torch import sketch as sketch_mod
    from findkmer_torch import spectra

    if sketch_mod.is_sketch_file(args.input):
        sk = sketch_mod.read_sketch(args.input)
        _emit_kv({key: sk[key] for key in
                  ("format", "name", "k", "s", "canonical", "n_hashes")},
                 args.json)
        return 0
    _emit_kv(spectra.info_spectrum_file(args.input, sep=args.sep),
             args.json)
    return 0


def _compare_pair(path_a, path_b, args):
    """One similarity comparison, sketch-aware.  A mixed pair sketches
    the spectrum side on the fly with the sketch's own k/s/canonical so
    the estimate is well-defined."""
    from findkmer_torch import sketch as sketch_mod
    from findkmer_torch import spectra

    pair = [path_a, path_b]
    is_sk = [sketch_mod.is_sketch_file(p) for p in pair]
    if not any(is_sk):
        return spectra.similarity_spectra(
            path_a, path_b, sep=args.sep, canonical=args.canonical
        )
    sks = []
    ref = next(
        sketch_mod.read_sketch(p) for p, s in zip(pair, is_sk) if s
    )
    if args.canonical and not bool(ref["canonical"]):
        # folding only the spectrum side would always fail
        # compare_sketches' canonical-mismatch guard AFTER doing the
        # sketch work — reject the flag combination up front instead
        raise ValueError(
            "--canonical cannot apply to a non-canonical sketch "
            f"({ref.get('name', '?')}); re-sketch it with --canonical "
            "or drop the flag"
        )
    for path, s in zip(pair, is_sk):
        if s:
            sks.append(sketch_mod.read_sketch(path))
        else:
            sk = sketch_mod.sketch_spectrum_file(
                path, s=int(ref["s"]), sep=args.sep,
                canonical=bool(ref["canonical"]),
            )
            sk["name"] = str(path)
            sks.append(sk)
    return sketch_mod.compare_sketches(sks[0], sks[1])


def cmd_similarity(args, **_kernels) -> int:
    """Jaccard/containment/cosine/Mash between spectra or sketches.

    Two inputs: full metric report.  Three or more (mash dist class):
    one row per unordered pair — jaccard, mash_distance, shared."""
    if len(args.input) < 2:
        raise ValueError("similarity needs at least two inputs")
    if len(args.input) == 2:
        _emit_kv(_compare_pair(args.input[0], args.input[1], args),
                 args.json)
        return 0
    rows = []
    for i in range(len(args.input)):
        for j in range(i + 1, len(args.input)):
            d = _compare_pair(args.input[i], args.input[j], args)
            d.setdefault("name_a", str(args.input[i]))
            d.setdefault("name_b", str(args.input[j]))
            rows.append(d)
    if args.json:
        print(json.dumps(rows))
        return 0
    print("a\tb\tjaccard\tmash_distance\tshared")
    for d in rows:
        print(
            f"{d['name_a']}\t{d['name_b']}\t{d['jaccard']:.6g}"
            f"\t{d['mash_distance']:.6g}\t{d['shared']}"
        )
    return 0


def cmd_sketch(args, **_kernels) -> int:
    """Write a bottom-s MinHash sketch of a sample (Mash tool class).

    With -k the inputs are sequence files (FASTA/FASTQ/SAM/BAM, one
    sample like `count`); without -k the single input is a spectrum
    file whose k is inferred.  --per-input sketches each input as its
    own sample into <stem>.sketch.json under -o DIR (mash sketch
    workflow: many samples, then `similarity` on the sketches).  Sequence
    inputs are counted on --device."""
    from findkmer_torch import sketch as sketch_mod
    from findkmer_torch.device import resolve_device

    if args.s < 1:
        raise ValueError(f"sketch size -s must be >= 1, got {args.s}")
    # sequence inputs count on --device: a missing card fails here,
    # before -o DIR is made
    device = resolve_device(args.device) if args.k > 0 else None
    if args.per_input:
        if args.k <= 0:
            raise ValueError("sketch --per-input requires -k")
        if args.output in ("", "-"):
            raise ValueError("sketch --per-input requires -o DIR")
        os.makedirs(args.output, exist_ok=True)
        # basename stems collide across directories (run1/s1.fa and
        # run2/s1.fa); de-collide with .2/.3 suffixes like count
        # --per-input does, so no sample's sketch is silently overwritten
        seen: dict = {}
        for path in args.input:
            sk = sketch_mod.sketch_sequences(
                [path], args.k, s=args.s, canonical=args.canonical,
                device=device,
            )
            # the shared --per-input naming convention (_input_stem)
            stem = _input_stem(
                path, seen,
                exts=_SEQ_EXTS + (".sam", ".bam"),
            )
            out_path = os.path.join(args.output, stem + ".sketch.json")
            with open(out_path, "wb") as f:
                sketch_mod.write_sketch(sk, f)
                f.write(b"\n")
            print(f"{out_path}: {sk['n_hashes']} hashes", file=sys.stderr)
        return 0
    if args.k > 0:
        sk = sketch_mod.sketch_sequences(
            args.input, args.k, s=args.s, canonical=args.canonical,
            name=args.name or None, device=device,
        )
    else:
        if len(args.input) != 1:
            raise ValueError(
                "sketch: without -k, pass exactly one spectrum file "
                "(use -k K to sketch sequence inputs as one sample)"
            )
        sk = sketch_mod.sketch_spectrum_file(
            args.input[0], s=args.s, sep=args.sep,
            canonical=args.canonical, name=args.name or None,
        )
    out, own = _open_out(args.output)
    try:
        sketch_mod.write_sketch(sk, out)
        out.write(b"\n")
    finally:
        if own:
            out.close()
    print(
        f"sketched {sk['n_hashes']} hashes (k={sk['k']}, s={sk['s']}"
        f"{', canonical' if sk['canonical'] else ''})",
        file=sys.stderr,
    )
    return 0


def cmd_diff(args, **_kernels) -> int:
    """Diff two spectrum files.  Default: the streaming two-pointer
    walk (O(buffers) memory — chr-scale 2.4 GB spectra never fit the
    dict path).  --in-memory restores the dict path for unsorted
    inputs."""
    from findkmer_torch import spectra

    if args.in_memory:
        a = spectra.read_spectrum(args.input[0], sep=args.sep)
        b = spectra.read_spectrum(args.input[1], sep=args.sep)
        lines = iter(spectra.diff_spectra(a, b))
    else:
        lines = spectra.diff_sorted_streaming(
            args.input[0], args.input[1], sep=args.sep
        )
    shown = extra = 0
    try:
        for d in lines:
            if shown < args.limit:
                print(d)
                shown += 1
            else:
                extra += 1
    except ValueError as e:
        if "not sorted" in str(e):
            raise ValueError(
                f"{e} — or rerun with `diff --in-memory` "
                "(loads both spectra into RAM)"
            ) from e
        raise
    if extra:
        print(f"... and {extra} more")
    return 1 if (shown or extra) else 0


def cmd_histo(args, **_kernels) -> int:
    """Count-of-counts histogram (KMC `histogram`-style output): of a
    recount on --device, or of spectrum files (--from-spectrum, host
    only)."""
    if args.from_spectrum:
        # histogram an existing spectrum file — no recount, no device
        from findkmer_torch import spectra

        h = None
        for path in args.input:
            hi = spectra.histo_spectrum_file(
                path, max_count=args.max_count, sep=args.sep
            )
            h = hi if h is None else h + hi
        sep = args.sep
    else:
        from findkmer_torch import api

        cfg = _cfg_from_args(args)
        _refuse_unported(args, cfg)
        spec = api.count(args.input, cfg.k, canonical=cfg.canonical,
                         config=cfg, device=args.device)
        h = spec.histo(max_count=args.max_count)
        sep = cfg.sep
    f, close = _open_out(args.output)
    try:
        for m in range(1, h.size):
            if h[m] or not args.nonzero_only:
                f.write(f"{m}{sep}{int(h[m])}\n".encode())
    finally:
        if close:
            f.close()
    return 0


def _add_thresholds(p: argparse.ArgumentParser) -> None:
    p.add_argument("--min-count", type=int, default=0, metavar="N",
                   help="suppress output of k-mers with count < N "
                        "(KMC -ci)")
    p.add_argument("--max-count", type=int, default=0, metavar="N",
                   help="suppress output of k-mers with count > N "
                        "(KMC -cx; 0 = off)")


def build_parser() -> argparse.ArgumentParser:
    from findkmer_torch.version import __version__

    p = argparse.ArgumentParser(
        prog="findkmer-torch",
        description="exact k-mer counter, PyTorch/CUDA port of findkmer-tpu",
    )
    p.add_argument("--version", action="version",
                   version=f"findkmer-torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("count", help="count k-mers, emit spectrum")
    _add_common(pc)
    _add_thresholds(pc)
    pc.add_argument("--per-input", action="store_true",
                    help="one spectrum file per input (-o names a "
                         "directory; files are <input-stem>.tsv)")
    pc.add_argument("--per-record", action="store_true",
                    help="one spectrum per FASTA record / FASTQ read, "
                         "as '>header' sections in one output stream")
    _add_device(pc, "count on")
    pc.set_defaults(fn=cmd_count)

    ps = sub.add_parser("stream", help="streaming count with checkpointing")
    _add_common(ps)
    _add_thresholds(ps)
    ps.add_argument("--checkpoint", default=None,
                    help="checkpoint directory (enables resume)")
    ps.add_argument("--checkpoint-every", type=int, default=64,
                    help="batches between checkpoints")
    ps.add_argument("--num-processes", type=int, default=None,
                    help="multi-host: total host processes "
                         "(env FINDKMER_NUM_PROCESSES)")
    ps.add_argument("--process-id", type=int, default=None,
                    help="multi-host: this host's index "
                         "(env FINDKMER_PROCESS_ID)")
    ps.add_argument("--coordinator", default=None,
                    help="multi-host: coordinator address of a process "
                         "group (env FINDKMER_COORDINATOR; not yet "
                         "ported).  Without it each host emits a partial "
                         "spectrum")
    _add_device(ps, "count on")
    ps.set_defaults(fn=cmd_stream)

    pt = sub.add_parser("stats", help="stream statistics only (no device)")
    _add_common(pt)
    pt.set_defaults(fn=cmd_stats)

    pm = sub.add_parser(
        "merge", help="merge spectrum TSV files (multi-host tail)"
    )
    pm.add_argument("-i", "--input", required=True, nargs="+",
                    help="spectrum files (KMER<sep>COUNT)")
    pm.add_argument("-o", "--output", default="-")
    pm.add_argument("-k", type=int, default=0,
                    help="k (only needed with -z)")
    pm.add_argument("-z", "--zeros", action="store_true")
    pm.add_argument("--canonical", action="store_true",
                    help="with -z: interleave zeros over the CANONICAL "
                         "code space (kmers with kmer <= revcomp) — for "
                         "merging spectra counted with --canonical")
    pm.add_argument("--op", choices=["sum", "min", "max"], default="sum",
                    help="counter operation for k-mers present in "
                         "several inputs (kmc_tools union counter-"
                         "calculation modes)")
    pm.add_argument("--sep", default="\t")
    pm.add_argument("--in-memory", action="store_true",
                    help="dict-based merge (accepts unsorted inputs; "
                         "default is a streaming sorted merge in O(MB) "
                         "memory)")
    pm.set_defaults(fn=cmd_merge)

    px = sub.add_parser(
        "matrix",
        help="k-mer x sample count matrix from spectrum files "
             "(kmtricks-class multi-sample aggregation)",
    )
    px.add_argument("-i", "--input", required=True, nargs="+",
                    help="sorted spectrum files, one per sample "
                         "(canonical spectra: canonize every input "
                         "first) — or sequence files with -k")
    px.add_argument("-k", type=int, default=0,
                    help="treat inputs as sequence files "
                         "(FASTA/FASTQ/SAM/BAM): count each at this k "
                         "first, one sample per input")
    px.add_argument("--canonical", action="store_true",
                    help="with -k: canonical (revcomp-min) counting")
    px.add_argument("-o", "--output", default="-")
    px.add_argument("--names", default="",
                    help="comma-separated column names (default: "
                         "input basename stems)")
    px.add_argument("--min-total", type=int, default=0,
                    help="drop rows whose count sum is below N")
    px.add_argument("--min-samples", type=int, default=0,
                    help="drop rows with fewer than N nonzero samples")
    px.add_argument("--sep", default="\t")
    _add_device(px, "count on")
    px.set_defaults(fn=cmd_matrix)

    pe = sub.add_parser(
        "expr",
        help="set-algebra expression over spectra (kmc_tools complex)",
        epilog="operators: A+B union/sum, A*B intersect/min, A-B "
               "k-mers of A absent from B, A~B counter subtract "
               "(kept > 0); '*' binds tighter, parentheses group. "
               "Example: findkmer expr '(A + B) - C' "
               "-i A=a.tsv B=b.tsv C=c.tsv",
    )
    pe.add_argument("expression",
                    help="e.g. '(A + B) * C' — names defined by -i")
    pe.add_argument("-i", "--input", required=True, nargs="+",
                    metavar="NAME=PATH",
                    help="sorted spectrum files bound to expression "
                         "names")
    pe.add_argument("-o", "--output", default="-")
    pe.add_argument("--canonical", action="store_true",
                    help="fold every input to revcomp-min form first")
    pe.add_argument("--sep", default="\t")
    pe.set_defaults(fn=cmd_expr)

    for op, hlp in (
        ("intersect", "k-mers in every input, count = min (streaming)"),
        ("subtract", "first input minus the others, rows <= 0 dropped"),
    ):
        po = sub.add_parser(op, help=hlp)
        po.add_argument("-i", "--input", required=True, nargs="+",
                        help="sorted spectrum files (KMER<sep>COUNT)")
        po.add_argument("-o", "--output", default="-")
        po.add_argument("--sep", default="\t")
        po.add_argument("--canonical", action="store_true",
                        help="fold every input to canonical (revcomp-min) "
                             "form before the op; plain and canonical "
                             "inputs may be mixed")
        if op == "subtract":
            po.add_argument(
                "--mode", choices=["counters", "kmers"],
                default="counters",
                help="counters: subtract the other inputs' counts, drop "
                     "rows <= 0 (kmc_tools counters_subtract); kmers: "
                     "drop a k-mer entirely if present in any other "
                     "input (kmc_tools kmers_subtract)")
        po.set_defaults(fn=cmd_setop)

    pso = sub.add_parser(
        "sort", help="sort/normalize a spectrum file (unsorted or "
                     "mixed-case third-party TSVs)"
    )
    pso.add_argument("input", help="spectrum file (KMER<sep>COUNT)")
    pso.add_argument("-o", "--output", default="-")
    pso.add_argument("--sep", default="\t")
    pso.add_argument("--min-count", type=int, default=1, metavar="N",
                     help="drop k-mers with count < N (kmc_tools "
                          "transform reduce -ci)")
    pso.add_argument("--max-count", type=int, default=0, metavar="N",
                     help="drop k-mers with count > N; 0 = unbounded "
                          "(kmc_tools transform reduce -cx)")
    pso.add_argument("--set-count", type=int, default=0, metavar="N",
                     help="force every surviving counter to N "
                          "(kmc_tools transform set_counts)")
    pso.add_argument("--kmers-only", action="store_true",
                     help="emit only the k-mer column (kmc_tools "
                          "transform compact)")
    pso.set_defaults(fn=cmd_sort)

    pz = sub.add_parser(
        "canonize", help="fold a spectrum to canonical (revcomp-min) form"
    )
    pz.add_argument("input", help="spectrum file (KMER<sep>COUNT)")
    pz.add_argument("-o", "--output", default="-")
    pz.add_argument("--sep", default="\t")
    pz.set_defaults(fn=cmd_canonize)

    pq = sub.add_parser("query", help="look up counts of specific k-mers")
    pq.add_argument("spectrum", help="sorted spectrum file")
    pq.add_argument("kmers", nargs="*", help="k-mers to look up")
    pq.add_argument("--kmers-file", default="",
                    help="file of whitespace-separated k-mers to look "
                         "up ('-' = stdin); combined with positionals")
    pq.add_argument("--sep", default="\t")
    pq.add_argument("--canonical", action="store_true",
                    help="spectrum is canonical: fold each queried k-mer "
                         "to revcomp-min form for the lookup")
    pq.set_defaults(fn=cmd_query)

    pn = sub.add_parser("topn", help="n most frequent k-mers")
    pn.add_argument("spectrum", help="spectrum file")
    pn.add_argument("-n", type=int, default=25)
    pn.add_argument("--sep", default="\t")
    pn.set_defaults(fn=cmd_topn)

    ph = sub.add_parser(
        "histo", help="count-of-counts histogram of the spectrum"
    )
    _add_common(ph)
    ph.add_argument("--max-count", type=int, default=10000,
                    help="clip multiplicities above this into one bin")
    ph.add_argument("--nonzero-only", action="store_true")
    ph.add_argument("--from-spectrum", action="store_true",
                    help="inputs are spectrum TSV files (no recount; "
                         "-k is ignored)")
    _add_device(ph, "count on")
    ph.set_defaults(fn=cmd_histo)

    pif = sub.add_parser(
        "info", help="summary statistics of a spectrum file"
    )
    pif.add_argument("input", help="spectrum file (KMER<sep>COUNT)")
    pif.add_argument("--sep", default="\t")
    pif.add_argument("--json", action="store_true",
                     help="one JSON object instead of key<TAB>value lines")
    pif.set_defaults(fn=cmd_info)

    psim = sub.add_parser(
        "similarity",
        help="similarity metrics between two spectra (Jaccard, "
             "containment, weighted Jaccard, cosine, Mash distance)",
    )
    psim.add_argument("-i", "--input", required=True, nargs="+",
                      help="two or more spectrum files and/or sketch "
                           "files (2 = full report; 3+ = pairwise rows, "
                           "mash dist class)")
    psim.add_argument("--sep", default="\t")
    psim.add_argument("--canonical", action="store_true",
                      help="fold both inputs to revcomp-min form first "
                           "(plain and canonical spectra may be mixed)")
    psim.add_argument("--json", action="store_true",
                      help="one JSON object instead of key<TAB>value "
                           "lines")
    psim.set_defaults(fn=cmd_similarity)

    psk = sub.add_parser(
        "sketch",
        help="bottom-s MinHash sketch of a sample (Mash class); compare "
             "sketches with `findkmer similarity`",
    )
    psk.add_argument("-i", "--input", required=True, nargs="+",
                     help="sequence file(s) (with -k, counted as ONE "
                          "sample) or one spectrum file (without -k)")
    psk.add_argument("-k", type=int, default=0,
                     help="k-mer length — sketch sequence inputs; omit "
                          "to sketch a spectrum file (k inferred)")
    psk.add_argument("-o", "--output", default="-",
                     help="sketch JSON ('-' = stdout; .gz compresses)")
    psk.add_argument("-s", type=int, default=1000,
                     help="sketch size: keep the s smallest k-mer "
                          "hashes (default 1000)")
    psk.add_argument("--canonical", action="store_true",
                     help="fold k-mers to revcomp-min before hashing")
    psk.add_argument("--name", default="",
                     help="sample name stored in the sketch "
                          "(default: the input path)")
    psk.add_argument("--per-input", action="store_true",
                     help="one sketch per input file, written to "
                          "<stem>.sketch.json under -o DIR "
                          "(requires -k)")
    psk.add_argument("--sep", default="\t")
    _add_device(psk, "count on")
    psk.set_defaults(fn=cmd_sketch)

    pd = sub.add_parser(
        "diff", help="diff two spectrum files (exit 1 when different)"
    )
    pd.add_argument("-i", "--input", required=True, nargs=2)
    pd.add_argument("--sep", default="\t")
    pd.add_argument("--limit", type=int, default=50)
    pd.add_argument("--in-memory", action="store_true",
                    help="dict-based diff (unsorted inputs; loads both "
                         "spectra into RAM — default streams sorted "
                         "inputs in O(buffers) memory)")
    pd.set_defaults(fn=cmd_diff)

    pf = sub.add_parser(
        "filter",
        help="keep/drop reads by spectrum membership (kmc_tools filter)",
        epilog="exit status: 0 = some reads kept, 1 = none kept "
               "(grep convention), 2 = trouble",
    )
    pf.add_argument("-i", "--input", required=True, nargs="+",
                    help="FASTA/FASTQ file(s), optionally gzipped")
    pf.add_argument("--spectrum", required=True,
                    help="spectrum TSV the reads are matched against "
                         "(k is inferred from it)")
    pf.add_argument("-o", "--output", default="-",
                    help="passing records, input record format "
                         "preserved (gzip-compressed when the path "
                         "ends in .gz)")
    pf.add_argument("--format", choices=["auto", "fasta", "fastq"],
                    default="auto")
    pf.add_argument("--min-hits", type=int, default=1, metavar="N",
                    help="keep reads with >= N k-mer hits (default 1)")
    pf.add_argument("--min-frac", type=float, default=None, metavar="F",
                    help="additionally require hits/valid-windows >= F")
    pf.add_argument("--min-count", type=int, default=0,
                    help="only spectrum entries with count >= N count "
                         "as hits")
    pf.add_argument("--max-count", type=int, default=0,
                    help="only spectrum entries with count <= N (0=off)")
    pf.add_argument("--canonical", action="store_true",
                    help="canonical matching: fold both spectrum and "
                         "read k-mers to revcomp-min form")
    pf.add_argument("--invert", action="store_true",
                    help="keep the complement (reads that do NOT pass)")
    pf.add_argument("--engine", choices=["auto", "host", "device"],
                    default="auto",
                    help="membership scorer: host = OpenMP C scan, "
                         "device = membership probe on --device (auto "
                         "picks device on --device cuda, host on "
                         "--device cpu)")
    pf.add_argument("--paired", action="store_true",
                    help="paired-end mode: -i R1 R2, pairs kept/dropped "
                         "together, -o OUT_R1,OUT_R2 (outputs stay "
                         "index-synchronized)")
    pf.add_argument("--pair-mode", choices=["any", "both"],
                    default="any",
                    help="pair passes when ANY mate passes (default) "
                         "or only when BOTH do")
    pf.add_argument("--sep", default="\t")
    _add_device(pf, "score on")
    pf.set_defaults(fn=cmd_filter)

    pst = sub.add_parser(
        "selftest",
        help="count synthetic DNA on this device and diff bit-exactly "
             "against a built-in scalar reference (deployment sanity "
             "check: bad install / device / native lib fails loudly)",
    )
    pst.add_argument("--devices", type=int, default=1,
                     help="devices in the counting mesh (only 1 is ported)")
    pst.add_argument("--seed", type=int, default=0)
    _add_device(pst, "test")
    pst.set_defaults(fn=cmd_selftest)
    return p


def _add_device(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help=f"torch device to {what} (default cuda; cuda "
                        "without a CUDA device is an error)")


def cmd_selftest(args, row_sort: str = "auto",
                 dense_kernel: str = "fused") -> int:
    from findkmer_torch import selftest

    if args.devices != 1:
        raise NotImplementedError(
            f"--devices {args.devices} is not yet ported to findkmer_torch "
            "(ROADMAP.md Queue 1 item 13)"
        )
    return selftest.run(args, row_sort=row_sort, dense_kernel=dense_kernel)


def main(argv=None, *, row_sort: str = "auto",
         dense_kernel: str = "fused") -> int:
    """The CLI.  row_sort and dense_kernel pick the counter's kernels for
    callers in Python (`cmd_count`); they are no flags."""
    from findkmer_torch.utils.shmalloc import ensure_shared_alloc

    ensure_shared_alloc()  # before any large host buffer is allocated
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args, row_sort=row_sort, dense_kernel=dense_kernel)
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        # one clean line for expected failures (NotImplementedError is a
        # RuntimeError); FINDKMER_TRACEBACK=1 shows the full stack.
        # Exit 2, as argparse usage errors.
        if os.environ.get("FINDKMER_TRACEBACK") == "1":
            raise
        print(f"findkmer-torch: error: {e}", file=sys.stderr)
        return 2
    except BrokenPipeError:
        return 0  # e.g. `findkmer-torch count ... | head`


if __name__ == "__main__":
    sys.exit(main())
