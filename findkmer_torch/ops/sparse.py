"""Sparse-table helpers of the port.

Only `ladder` for now: the host batcher sizes a first-and-only partial
batch with it (`pipeline._BatchEmitter.finish`).  The sparse store itself
(`findkmer_tpu/ops/sparse.py`) is ported with the sparse slice.
"""

from __future__ import annotations


def ladder(n: int, floor: int = 1 << 20) -> int:
    """Smallest padded size >= n from the {1, 1.5} x 2^i ladder.

    Bounds padding waste (<= 50%, usually <= 33%) and the number of
    distinct batch shapes a run produces."""
    c = floor
    while True:
        if n <= c:
            return c
        if n <= c + c // 2:
            return c + c // 2
        c *= 2
