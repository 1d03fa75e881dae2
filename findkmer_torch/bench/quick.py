"""`findkmer-torch bench`: the quick on-device throughput check.

Without `--phases` it times one staged step (`steps.py`) for about
`--gbases` billion bases and prints one JSON line (`k`, `bases_per_s`,
`wall_s`, `device`, `hist`): a rate of the device step alone, with the
batch already on the device.  With `--phases` it counts a synthetic FASTA
of `--gbases` billion bases end to end (`pipeline.run_count`, the
finalize, the spectrum written to /dev/null) and prints the wall-clock
phases `host_batches`, `dispatch`, `finalize` and `write` as a table on
stderr and in its JSON line, under the reference's names.
"""

from __future__ import annotations

import json


def _synth_fasta(path: str, bases: int, seed: int = 0) -> None:
    """Write `bases` of random ACGT as one FASTA record (80-col lines)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(b">bench synthetic\n")
        chunk = 8_000_000  # bases per write block (100k lines)
        for s in range(0, bases, chunk):
            n = min(chunk, bases - s)
            seq = alphabet[rng.integers(0, 4, n)]
            rows = -(-n // 80)
            block = np.full((rows, 81), ord("\n"), dtype=np.uint8)
            pad = rows * 80 - n
            if pad:
                seq = np.concatenate([seq, np.full(pad, ord("A"), np.uint8)])
            block[:, :80] = seq.reshape(rows, 80)
            f.write(block.tobytes())


def run_phases(args, device) -> int:
    """End-to-end phase breakdown on synthetic data, counted on
    `device`.  The finalize is timed as one phase, without the counter's
    own sub-phases (`count --stats json` reports those).  A sparse store
    may hold 2^28 distinct k-mers, as in the staged step and at the
    ceiling `count` sizes to, where the reference keeps the 2^22 default
    and fails past it (any --gbases above about 0.004 at k=21)."""
    import os
    import sys
    import tempfile
    import time

    from findkmer_torch import output as output_mod
    from findkmer_torch.config import Config
    from findkmer_torch.pipeline import StreamStats, run_count
    from findkmer_torch.utils.prof import PhaseTimers

    bases = int(args.gbases * 1e9)
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "bench.fa")
        t0 = time.perf_counter()
        _synth_fasta(fa, bases)
        gen_s = time.perf_counter() - t0
        cfg = Config(k=args.k, canonical=args.canonical, hist=args.hist,
                     sparse_capacity=1 << 28, sparse_expected_entries=bases)
        timers = PhaseTimers()
        stats = StreamStats()
        t0 = time.perf_counter()
        counter, state = run_count(fa, cfg, device, stats=stats,
                                   timers=timers)
        with timers.phase("finalize"):
            spectrum = counter.finalize(state)
        with timers.phase("write"):
            with open(os.devnull, "wb") as f:
                output_mod.write_spectrum(f, spectrum, cfg)
        wall = time.perf_counter() - t0
        phases = timers.as_dict()
        print(f"# synthetic input: {bases/1e6:.0f} Mbp "
              f"(generated in {gen_s:.1f}s, excluded)", file=sys.stderr)
        print(f"# {'phase':<14}{'total_s':>10}{'calls':>8}{'share':>8}",
              file=sys.stderr)
        for name, d in phases.items():
            print(f"# {name:<14}{d['total_s']:>10.2f}{d['calls']:>8}"
                  f"{d['total_s']/wall:>7.0%}", file=sys.stderr)
        print(json.dumps({
            "k": args.k,
            "bases": bases,
            "wall_s": wall,
            "bases_per_s": bases / wall,
            "phases": phases,
        }))
    return 0


def run(args) -> int:
    """The subcommand.  The reference's geometry rule (k <= 15: 256 x
    65536 rows, else 32 x 16384; about --gbases bases in all), and the
    step of the counter's own table mode: dense for k <= direct_k_max,
    the sparse step above, also at 11 <= k <= 15 (where the reference
    sends the rows to its dense step and fails)."""
    from findkmer_torch.bench import steps
    from findkmer_torch.config import DIRECT, Config

    device = steps.setup(args.device)
    if args.phases:
        return run_phases(args, device)
    total = int(args.gbases * 1e9)
    chunk_len = 65536 if args.k <= 15 else 16384
    batch_rows = 256 if args.k <= 15 else 32
    n = max(1, total // (batch_rows * chunk_len))
    if Config(k=args.k).resolved_table_mode == DIRECT:
        bps, dt = steps.bench_dense_step(
            device, k=args.k, batch_rows=batch_rows, chunk_len=chunk_len,
            steps=n, hist=args.hist, canonical=args.canonical,
        )
    else:
        bps, dt = steps.bench_sparse_step(
            device, k=args.k, batch_rows=batch_rows, chunk_len=chunk_len,
            steps=n, canonical=args.canonical,
        )
    print(json.dumps({
        "k": args.k,
        "bases_per_s": bps,
        "wall_s": dt,
        "device": str(device),
        "hist": args.hist,
    }))
    return 0
