"""A multi-chromosome reference as one seeded chr1-like record: the
parameters and the generator of `chr1_like` (its length the chromosomes'
summed), with a tiny size of its own.

At `chr1_like`'s tiny size the satellite arrays hold ~400 monomer copies,
so the monomer's 15-mers are seen ~290 times: under the --min-count of a
thresholded whole-genome count (`k15c.repeats`: 341), which would leave
the CPU tests' output empty.  Here the tiny arrays are 6-9 kbase, ~660
copies, so those 15-mers are seen ~490 times and pass it."""

from __future__ import annotations

from kmerbench.gen import chr1_like

generate = chr1_like.generate


def tiny(p: dict) -> dict:
    """The same traffic at a size the CPU tests hold."""
    small = chr1_like.tiny(p)
    return {**small,
            "satellite": {**small["satellite"], "array_len": [6000, 9000]}}
