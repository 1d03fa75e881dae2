"""A seeded paired-end read set of a diploid genome: GenomeScope's input.

Parameters (all in the traffic file):
  genome, gc          haplotype A: `genome` random bases at that GC share
  het                 haplotype B: A with this share of its bases substituted
  read_len            bases a read
  insert: [mean, sd]  fragment length, normal, at least read_len
  coverage            read bases / genome bases (both mates counted)
  err: [first, last]  substitution rate at a read's first and last base,
                      linear in between
  n_rate              share of bases called N
  chunk               pairs generated and written at a time
Each pair comes from a haplotype and a strand, each 50/50: R1 reads the
fragment's start on its strand, R2 the other end on the other strand.
Qualities are Phred+33 of the position's error rate (N bases '#').  A
read's header names its origin: haplotype, start on the forward strand
of the haplotype, and strand ('-': the reverse complement of that span).
Writes R1.fq and R2.fq; reads never cross a fragment's ends.
"""

from __future__ import annotations

import os

import numpy as np

from kmerbench.gen.common import (ACGT, create, fastq_rows, random_codes,
                                  substitute)


def _quality(p: dict) -> tuple:
    """(per-position error rate, per-position quality letter)."""
    R = int(p["read_len"])
    err = np.linspace(p["err"][0], p["err"][1], R).astype(np.float32)
    q = np.clip(np.round(-10 * np.log10(err)), 2, 41).astype(np.uint8) + 33
    return err, q


def generate(out_dir: str, seed: int, p: dict) -> dict:
    rng = np.random.default_rng(seed)
    G, R = int(p["genome"]), int(p["read_len"])
    hap_a = random_codes(rng, G, float(p["gc"]))
    hap_b = hap_a.copy()
    substitute(hap_b, float(p["het"]), rng)
    haps = np.stack([hap_a, hap_b])
    del hap_a, hap_b
    err, qual_row = _quality(p)
    pairs = int(round(p["coverage"] * G / (2 * R)))
    chunk = int(p.get("chunk", 1 << 17))
    paths = [os.path.join(out_dir, "R1.fq"), os.path.join(out_dir, "R2.fq")]
    cols = np.arange(R)
    with create(paths[0]) as f1, create(paths[1]) as f2:
        for first in range(0, pairs, chunk):
            n = min(chunk, pairs - first)
            ins = np.clip(np.round(rng.normal(p["insert"][0], p["insert"][1],
                                              n)), R, G).astype(np.int64)
            start = (rng.random(n) * (G - ins + 1)).astype(np.int64)
            hap = rng.integers(0, 2, n)
            flip = rng.integers(0, 2, n).astype(bool)
            fwd = haps[hap[:, None], start[:, None] + cols]
            far = haps[hap[:, None], (start + ins - R)[:, None] + cols]
            far = 3 - far[:, ::-1]  # the other end, on the other strand
            r1 = np.where(flip[:, None], far, fwd)
            r2 = np.where(flip[:, None], fwd, far)
            far_at = start + ins - R
            for mate, reads, f, at, rc in (
                    (b"/1", r1, f1, np.where(flip, far_at, start), flip),
                    (b"/2", r2, f2, np.where(flip, start, far_at), ~flip)):
                reads = np.ascontiguousarray(reads)
                substitute(reads.reshape(-1),
                           np.broadcast_to(err, reads.shape).reshape(-1), rng)
                letters = ACGT[reads]
                q = np.broadcast_to(qual_row, reads.shape).copy()
                nn = rng.random(reads.shape, dtype=np.float32) < p["n_rate"]
                letters[nn] = ord("N")
                q[nn] = ord("#")
                f.write(fastq_rows(first, letters, q, mate, hap, at, rc)
                        .tobytes())
    return {"inputs": paths, "bases": 2 * pairs * R}


def tiny(p: dict) -> dict:
    """The same traffic at a size the CPU tests hold."""
    return {**p, "genome": 30_000, "coverage": 8, "chunk": 300}
