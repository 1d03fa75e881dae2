"""`count --per-input -o DIR`: one spectrum an input, in input order."""

from __future__ import annotations

from kmerbench.reference import kmers


def _one(path, k, canonical, device, variant):
    codes, counts = kmers.spectrum([path], k, canonical, device, variant)
    yield from kmers.tsv_pieces(codes, counts, k)


def streams(inputs, k: int, canonical: bool, device, variant: str = "exact"):
    return [_one(p, k, canonical, device, variant) for p in inputs]
