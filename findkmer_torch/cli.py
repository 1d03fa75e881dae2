"""findkmer-torch CLI: the `count` subcommand of the port.

    python -m findkmer_torch.cli count -i in.fa -k 8 -o out.tsv [--device cuda]

Same arguments and the same output bytes as `findkmer count` of the JAX
package, whose JAX-free argument and output helpers it reuses
(`findkmer_tpu.cli._add_common`, `_cfg_from_args`, `_open_out`;
`findkmer_tpu.output.write_spectrum`).  `--device` picks the torch
device; asking for cuda without one is an error, never a CPU run.

Not yet ported, each refused with one error line and exit 2:
`--per-input`, `--per-record`, `--spill`, `--devices` other than 1,
`--profile`, and k that resolves to a sparse table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from findkmer_tpu.cli import _add_common, _cfg_from_args, _open_out


def _refuse_unported(args, cfg) -> None:
    where = "ROADMAP.md Queue 1"
    unported = [
        (args.per_input, "--per-input", f"{where} item 6"),
        (args.per_record, "--per-record", f"{where} item 6"),
        (bool(args.spill), "--spill", f"{where} item 8"),
        (args.devices != 1, f"--devices {args.devices}", f"{where} item 13"),
        (args.profile is not None, "--profile", f"{where} item 12"),
        (cfg.resolved_table_mode != "direct",
         f"k={cfg.k} with a sparse table", f"{where} item 7"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not yet ported to findkmer_torch ({item})"
            )


def cmd_count(args) -> int:
    import torch

    from findkmer_tpu import output as output_mod
    from findkmer_tpu.utils.prof import PhaseTimers
    from findkmer_torch import pipeline
    from findkmer_torch.device import resolve_device

    if args.log:
        os.environ["FINDKMER_LOGLEVEL"] = args.log
    cfg = _cfg_from_args(args)
    _refuse_unported(args, cfg)
    device = resolve_device(args.device)
    stats = pipeline.StreamStats()
    timers = PhaseTimers() if args.stats == "json" else None

    t0 = time.time()
    # multiple inputs: one combined spectrum (records concatenated)
    spectrum = pipeline.count_file(args.input, cfg, device, stats=stats,
                                   timers=timers)

    f, close = _open_out(args.output)
    try:
        if timers is None:
            output_mod.write_spectrum(f, spectrum, cfg)
        else:
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
        if timers is not None:
            d["phases"] = timers.as_dict()
        print(json.dumps(d), file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    from findkmer_tpu.version import __version__

    p = argparse.ArgumentParser(
        prog="findkmer-torch",
        description="exact k-mer counter, PyTorch/CUDA port of findkmer-tpu",
    )
    p.add_argument("--version", action="version",
                   version=f"findkmer-torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("count", help="count k-mers, emit spectrum")
    _add_common(pc)
    pc.add_argument("--min-count", type=int, default=0, metavar="N",
                    help="suppress output of k-mers with count < N "
                         "(KMC -ci)")
    pc.add_argument("--max-count", type=int, default=0, metavar="N",
                    help="suppress output of k-mers with count > N "
                         "(KMC -cx; 0 = off)")
    pc.add_argument("--per-input", action="store_true",
                    help="one spectrum file per input (not yet ported)")
    pc.add_argument("--per-record", action="store_true",
                    help="one spectrum per record (not yet ported)")
    pc.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="torch device to count on (default cuda; cuda "
                         "without a CUDA device is an error)")
    pc.set_defaults(fn=cmd_count)
    return p


def main(argv=None) -> int:
    from findkmer_tpu.utils.shmalloc import ensure_shared_alloc

    ensure_shared_alloc()  # before any large host buffer is allocated
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
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
