"""`count -o FILE`: one spectrum of every input, counted as one."""

from __future__ import annotations

from kmerbench.reference import kmers


def streams(inputs, k: int, canonical: bool, device, variant: str = "exact"):
    codes, counts = kmers.spectrum(inputs, k, canonical, device, variant)
    return [kmers.tsv_pieces(codes, counts, k)]
