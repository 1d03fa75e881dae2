"""`histo --max-count M`: the count-of-counts of every input, counted as
one, multiplicities 1..M, those above M in bin M."""

from __future__ import annotations

from kmerbench.reference import kmers


def streams(inputs, k: int, canonical: bool, device, variant: str = "exact",
            max_count: int = 10000):
    _, counts = kmers.spectrum(inputs, k, canonical, device, variant)
    return [[kmers.histogram_lines(counts, max_count)]]
