"""A seeded cohort of bacterial isolate assemblies, one FASTA a sample:
`chip_smoke.py`'s `write_cohort`, extended with accessory segments,
plasmids and sample sizes.

Parameters (all in the traffic file):
  samples, gc         samples in the cohort; GC share of every sequence
  ancestor            bases of the shared ancestor the cores come from
  size: [lo, hi]      a sample's chromosome, accessory included
  accessory: [lo, hi] share of a chromosome in sample-specific segments
  segment: [lo, hi]   bases of an accessory segment
  block               the core keeps the ancestor in blocks of this many
                      bases, in order, dropping the rest
  div: [lo, hi]       substitution rate of a sample's chromosome
  plasmids: [lo, hi]  plasmids a sample carries, from a pool of
  pool                this many plasmids of
  plasmid_len: [lo, hi] bases each, diverged by
  plasmid_div         this rate in each sample
Sizes, accessory shares, divergences and plasmid counts are evenly spread
over their ranges, the same set for every seed, dealt to the samples in
an order drawn from the seed.
Records: "<name> chromosome", then "<name> plasmid <i>".  Files are
isolateNN.fa, so --per-input names them isolateNN.tsv.
"""

from __future__ import annotations

import os

import numpy as np

from kmerbench.gen.common import (ACGT, create, random_codes, spread,
                                  substitute, write_record)


def _sample(rng, p: dict, ancestor: np.ndarray, pool: list, size: int,
            acc_share: float, div: float, plasmids: list) -> list:
    """[(record name, codes)] of one sample."""
    gc = float(p["gc"])
    acc = int(size * acc_share)
    block = int(p["block"])
    blocks = ancestor.size // block
    keep = np.sort(rng.choice(blocks, min(blocks, (size - acc) // block),
                              replace=False))
    parts = [ancestor[b * block : (b + 1) * block] for b in keep]
    segs = []
    while acc > 0:
        n = min(acc, int(rng.integers(p["segment"][0], p["segment"][1] + 1)))
        segs.append(random_codes(rng, n, gc))
        acc -= n
    slots = rng.integers(0, len(parts) + 1, len(segs))
    for slot, seg in sorted(zip(slots, segs), key=lambda t: -t[0]):
        parts.insert(int(slot), seg)
    chrom = np.concatenate(parts)
    substitute(chrom, div, rng)
    records = [("chromosome", chrom)]
    for i in plasmids:
        pl = pool[i].copy()
        substitute(pl, float(p["plasmid_div"]), rng)
        records.append((f"plasmid {i + 1}", pl))
    return records


def generate(out_dir: str, seed: int, p: dict) -> dict:
    rng = np.random.default_rng(seed)
    gc = float(p["gc"])
    n = int(p["samples"])
    ancestor = random_codes(rng, int(p["ancestor"]), gc)
    lens = spread(rng, *p["plasmid_len"], int(p["pool"])).astype(np.int64)
    pool = [random_codes(rng, int(ln), gc) for ln in lens]
    # every seed: the same sizes, accessory shares, divergences and
    # plasmid counts, dealt to the samples in another order; each pool
    # plasmid carried about equally often
    sizes = spread(rng, *p["size"], n).astype(np.int64)
    accs = spread(rng, *p["accessory"], n)
    divs = spread(rng, *p["div"], n)
    lo, hi = p["plasmids"]
    counts = rng.permutation(lo + np.arange(n) % (hi - lo + 1))
    carried = rng.permutation(np.arange(int(counts.sum())) % len(pool))
    first = np.cumsum(counts) - counts
    paths, bases = [], 0
    for s in range(n):
        name = f"isolate{s + 1:02d}"
        path = os.path.join(out_dir, f"{name}.fa")
        pls = sorted(carried[first[s] : first[s] + counts[s]].tolist())
        with create(path) as f:
            for what, codes in _sample(rng, p, ancestor, pool, int(sizes[s]),
                                       float(accs[s]), float(divs[s]), pls):
                write_record(f, f"{name} {what}", ACGT[codes])
                bases += codes.size
        paths.append(path)
    return {"inputs": paths, "bases": bases}


def tiny(p: dict) -> dict:
    """The same traffic at a size the CPU tests hold."""
    return {**p, "samples": 3, "ancestor": 60_000, "size": [45_000, 55_000],
            "segment": [500, 2000], "block": 1000, "pool": 4,
            "plasmid_len": [200, 3000]}
