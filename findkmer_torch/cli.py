"""findkmer-torch CLI: the `count`, `stream`, `filter` and `selftest`
subcommands of the port.

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

Same arguments (flags, defaults, help texts, exit codes) and the same
output bytes as `findkmer count`, `findkmer stream` and `findkmer filter`
of the JAX package (whose checkpoints and spill runs the port reads, and
the other way round): `_add_common`,
`_cfg_from_args` with its sparse autosize, `_open_out` and the
--per-input file names `_per_input_name` are the port's own copies of
that CLI's helpers, and the spectrum is written by `findkmer_torch.output`
(`write_spectrum` and, for sparse tables, `write_spectrum_streaming` over
the counter's chunked finalize).  Any k up to 31 counts.  `--device` picks the torch device; asking for cuda without
one is an error, never a CPU run.  One exit code differs: `filter` refuses
SAM/BAM input with exit 2 (trouble), where the JAX CLI exits 1 (its
"nothing kept").

Not yet ported, each refused with one error line and exit 2: `--devices`
other than 1, `--profile`, and `stream --coordinator` with more than one
process.
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


def _count_per_input(args, cfg, device, kernels: dict) -> int:
    """--per-input: one spectrum file per input, written into -o DIR
    (files named <input stem>.tsv, a repeated stem as <stem>.2.tsv)."""
    from findkmer_torch import output as output_mod
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
    for path, out in zip(args.input, outs):
        spectrum = pipeline.count_file(path, cfg, device, stats=stats,
                                       **kernels)
        with open(out, "wb") as f:
            output_mod.write_spectrum(f, spectrum, cfg)
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
