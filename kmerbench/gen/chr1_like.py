"""A seeded chromosome-scale assembly record shaped like GRCh38 chr1.

Parameters (all in the traffic file):
  length, gc, header          the record: one FASTA record, 80 letters a line
  families                    interspersed repeat families, each
                              {unit, share, div: [lo, hi], truncate: bool}:
                              a random consensus of `unit` bases, copies on
                              either strand covering `share` of the record,
                              each copy diverged by a rate drawn from div;
                              `truncate` keeps a random 3' part of a copy
                              (5'-truncated, as L1 copies are), of
                              unit * u**2 bases, u uniform
  satellite                   {unit, arrays, array_len: [lo, hi], div}:
                              tandem arrays of one monomer beside the main
                              gap, their lengths evenly spread over
                              array_len, each monomer copy diverged by div
  microsat                    {share, motifs, run: [lo, hi], div}: short
                              tandem runs of the motifs
  gaps                        {n_total, main_share, main_at, telomere}:
                              N runs of n_total bases in all, main_share of
                              them in one block at main_at of the record,
                              `telomere` at each end, the rest in smaller
                              gaps between the other elements
Every repeat-derived letter is lowercase (soft-masked, as RepeatMasker
masks them).  Elements never overlap: they are laid out in a shuffled
order with unique sequence between them, so each share lands where its
parameter puts it.
"""

from __future__ import annotations

import os

import numpy as np

from kmerbench.gen.common import (ACGT, create, random_codes, spread,
                                  substitute, write_record)


def _family_lengths(rng, fam: dict, budget: int) -> np.ndarray:
    """Copy lengths of one family, summing to about `budget` bases."""
    unit = int(fam["unit"])
    mean = unit / 3 if fam.get("truncate") else unit
    n = int(budget / mean * 1.3) + 16
    if fam.get("truncate"):
        lens = np.maximum(
            50, (unit * rng.random(n) ** 2).astype(np.int64))
    else:
        lens = np.full(n, unit, np.int64)
    keep = np.searchsorted(np.cumsum(lens), budget, side="right")
    return lens[:max(keep, 1)]


def _copies(rng, consensus: np.ndarray, lens: np.ndarray,
            div) -> np.ndarray:
    """Concatenated copies of the 3' `lens[i]` bases of `consensus`, each
    diverged by its own rate from div and on a random strand."""
    unit = consensus.size
    total = int(lens.sum())
    first = np.cumsum(lens) - lens
    within = np.arange(total) - np.repeat(first, lens)
    rc = np.repeat(rng.integers(0, 2, lens.size).astype(bool), lens)
    ln = np.repeat(lens, lens)
    src = np.where(rc, ln - 1 - within, within) + unit - ln
    out = consensus[src]
    out[rc] = 3 - out[rc]
    rate = np.repeat(rng.uniform(div[0], div[1], lens.size)
                     .astype(np.float32), lens)
    substitute(out, rate, rng)
    return out


def _tandem(rng, motif: np.ndarray, length: int, div: float) -> np.ndarray:
    reps = -(-length // motif.size)
    out = np.tile(motif, reps)[:length].copy()
    substitute(out, div, rng)
    return out


def generate(out_dir: str, seed: int, p: dict) -> dict:
    rng = np.random.default_rng(seed)
    L, gc = int(p["length"]), float(p["gc"])
    # elements: (kind, length, payload) where kind 0 = masked repeat bases,
    # 1 = N gap; payload is the bases of a repeat element
    lens, kinds, payloads = [], [], []

    def add(kind, bases_or_len):
        if kind == 0:
            lens.append(bases_or_len.size)
            payloads.append(bases_or_len)
        else:
            lens.append(int(bases_or_len))
            payloads.append(None)
        kinds.append(kind)

    for fam in p.get("families", []):
        flens = _family_lengths(rng, fam, int(fam["share"] * L))
        consensus = random_codes(rng, int(fam["unit"]), gc)
        bases = _copies(rng, consensus, flens, fam["div"])
        for piece in np.split(bases, np.cumsum(flens)[:-1]):
            add(0, piece)
    ms = p.get("microsat")
    if ms:
        motifs = [np.frombuffer(m.encode(), np.uint8) for m in ms["motifs"]]
        motifs = [np.searchsorted(ACGT, m).astype(np.uint8) for m in motifs]
        budget, lo, hi = int(ms["share"] * L), ms["run"][0], ms["run"][1]
        while budget > 0:
            n = min(budget, int(rng.integers(lo, hi + 1)))
            add(0, _tandem(rng, motifs[int(rng.integers(len(motifs)))], n,
                           ms["div"]))
            budget -= n
    gaps = p["gaps"]
    main = int(gaps["n_total"] * gaps["main_share"])
    tel = int(gaps["telomere"])
    small_total = int(gaps["n_total"]) - main - 2 * tel
    n_small = int(gaps.get("small", 30))
    if small_total > 0 and n_small:
        cuts = np.sort(rng.integers(1, small_total, n_small - 1))
        for g in np.diff(np.concatenate([[0], cuts, [small_total]])):
            if g > 0:
                add(1, g)
    order = list(rng.permutation(len(lens)))
    # the main gap and the satellite arrays beside it, at main_at
    centre = []
    sat = p.get("satellite")
    if sat:
        mono = random_codes(rng, int(sat["unit"]), gc)
        for n in spread(rng, *sat["array_len"], int(sat["arrays"])):
            add(0, _tandem(rng, mono, int(n), sat["div"]))
            centre.append(len(lens) - 1)
    add(1, main)
    centre.insert(len(centre) // 2, len(lens) - 1)
    at = int(round(gaps["main_at"] * len(order)))
    order = order[:at] + centre + order[at:]

    lens_a = np.asarray(lens, np.int64)
    unique = L - 2 * tel - int(lens_a.sum())
    if unique < 0:
        raise ValueError("chr1_like: the elements do not fit in the record")
    cuts = np.sort(rng.integers(0, unique + 1, len(order)))
    spacer = np.diff(np.concatenate([[0], cuts]))
    ordered = lens_a[order]
    starts = tel + np.cumsum(spacer) + np.cumsum(ordered) - ordered

    codes = random_codes(rng, L, gc)
    letters = ACGT[codes]
    del codes
    for i, s in zip(order, starts):
        s = int(s)
        if kinds[i] == 0:
            letters[s : s + lens[i]] = ACGT[payloads[i]] | 0x20
        else:
            letters[s : s + lens[i]] = ord("N")
    letters[:tel] = ord("N")
    letters[L - tel :] = ord("N")
    path = os.path.join(out_dir, "chr1_like.fa")
    with create(path) as f:
        write_record(f, p.get("header", "chr1_like") + f" seed={seed}",
                     letters)
    return {"inputs": [path], "bases": L}


def tiny(p: dict) -> dict:
    """The same traffic at a size the CPU tests hold."""
    return {**p, "length": 400_000,
            "satellite": {**p["satellite"], "array_len": [3000, 6000]},
            "gaps": {**p["gaps"], "n_total": 30000, "telomere": 500,
                     "small": 6}}
