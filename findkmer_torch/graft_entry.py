"""Compile-check entry points of the port: one device step, one mesh run.

Counterpart of the repository's `__graft_entry__.py`:

    entry(device="cuda")        -> (fn, example_args): one device step of
                                   the k=8 dense counter at 64 x 1024
                                   (`KmerCounter.jitted_forward`; on a
                                   card K2's uint8-row entry)
    dryrun_multichip(n, device) -> every merge mode over a mesh of n
                                   shards (`parallel/dryrun.DryRun`: psum,
                                   psum_scatter, all_to_all on the full
                                   and on a scaled table, dp_sparse, the
                                   checkpoint round trip, the spill), each
                                   leg's spectrum held exactly to a numpy
                                   count of the same batches; raises on
                                   any difference

Both run on the card unless device="cpu" is asked for; without a card
"cuda" raises.  The mesh takes the visible cards in turn, so one card
holds several shards (the exchange runs, scaling does not show).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from findkmer_torch.config import Config

# the dry run's input: batches of 2 rows a shard, as the reference's dry
# run, of 2048 bases a row (its spill leg's): a shard's batch then holds
# more windows than the store's smallest compaction target (4096), so the
# spill leg compacts and spills every batch; 4 batches (the checkpoint
# leg writes after 2)
DRYRUN_ROWS_PER_SHARD = 2
DRYRUN_CHUNK = 2048
DRYRUN_BATCHES = 4
DRYRUN_N_SHARE = 0.02  # bases that are N (no window crosses one)


def entry(device: str = "cuda"):
    """(fn, example_args) of the k=8 dense step at 64 x 1024 on
    `device` ('cuda' without a card raises)."""
    from findkmer_torch.device import resolve_device
    from findkmer_torch.models.counter import KmerCounter

    cfg = Config(k=8, batch_rows=64, chunk_len=1024)
    counter = KmerCounter(cfg, resolve_device(device))
    return counter.jitted_forward()


def write_dryrun_fasta(path: str, n_devices: int, seed: int = 0) -> None:
    """The dry run's seeded input: two records of ACGT with ~2% N, as
    many bases as DRYRUN_BATCHES batches of the mesh's geometry hold."""
    rng = np.random.default_rng(seed)
    total = DRYRUN_BATCHES * DRYRUN_ROWS_PER_SHARD * n_devices * DRYRUN_CHUNK
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, total)]
    seq[rng.random(total) < DRYRUN_N_SHARE] = ord("N")
    half = total // 2
    with open(path, "wb") as f:
        for i, part in enumerate((seq[:half], seq[half:])):
            f.write(b">dryrun_%d\n" % i)
            f.write(part.tobytes() + b"\n")


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Every merge mode over a mesh of `n_devices` shards on `device`,
    each held exactly to its reference -> {leg: its record}.  Raises
    AssertionError on any difference, RuntimeError for 'cuda' without a
    card."""
    import torch

    from findkmer_torch.device import resolve_device
    from findkmer_torch.parallel.dryrun import DryRun
    from findkmer_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        shards = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        shards = [dev] * n_devices
    mesh = make_mesh(n_devices, devices=shards)
    with tempfile.TemporaryDirectory(prefix="findkmer_dryrun_") as d:
        path = os.path.join(d, "dryrun.fa")
        write_dryrun_fasta(path, n_devices)
        base = Config(batch_rows=DRYRUN_ROWS_PER_SHARD * n_devices,
                      chunk_len=DRYRUN_CHUNK)
        # the reference's legs: psum and psum_scatter at k=4, all_to_all
        # on the full 4^8 table, k=15 on a table scaled to 4^8, k=21 sparse
        run = DryRun(path, base, reference="host", device=mesh[0],
                     k_dense=4, k_route=8, k_scaled=15,
                     table_entries=4 ** 8, k_sparse=21)
        return run.run(mesh)
