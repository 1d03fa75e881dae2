"""`count --min-count / --max-count -o FILE`: `tsv_spectrum`'s one
spectrum of every input, counted as one, with the KMC-style output
thresholds applied before the lines are formatted: a k-mer's line is
written when its count is at least `min_count` and, where `max_count` is
not 0, at most `max_count`.  The counts stay exact; only lines are left
out."""

from __future__ import annotations

from kmerbench.reference import kmers


def streams(inputs, k: int, canonical: bool, device, variant: str = "exact",
            min_count: int = 0, max_count: int = 0):
    codes, counts = kmers.spectrum(inputs, k, canonical, device, variant)
    keep = counts >= min_count
    if max_count:
        keep &= counts <= max_count
    return [kmers.tsv_pieces(codes[keep], counts[keep], k)]


def meryl_min_count(counts, fraction: float = 0.9998) -> int:
    """The --min-count that keeps what `meryl print greater-than
    distinct=<fraction>` keeps: T is the smallest count at or below which
    `fraction` of the distinct k-mers lie, and greater-than is strict, so
    N = T + 1.  `counts`: a tensor of the distinct k-mers' counts."""
    import numpy as np
    import torch

    h = torch.bincount(counts.long()).cpu().numpy()
    target = fraction * int(h[1:].sum())
    return int(np.searchsorted(np.cumsum(h[1:]), target)) + 2
