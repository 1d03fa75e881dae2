"""Pieces the generators share: seeded bases at a GC share, substitutions,
reverse complements, and the FASTA and FASTQ writers.

Sequences are built as 2-bit codes (A=0, C=1, G=2, T=3, uint8) and turned
into letters once at the end.  `write_record` is `chip_smoke.py`'s
`_write_record`; `fastq_rows` extends its `_records` with qualities.

`create` opens an input for writing in memory, not on disk: a run writes
each input once and reads it in every job, and a disk would keep every
block and might flush it during the window; `release` frees them.
"""

from __future__ import annotations

import os
from typing import IO, List

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
CHUNK = 1 << 24
_HELD: List[int] = []  # the memory files of `create`, until `release`


def create(path: str) -> IO[bytes]:
    """A new file at `path` held in memory (a memfd; `path` is a symlink
    to it under /proc), open for writing; it lives until `release`."""
    fd = os.memfd_create(os.path.basename(path))
    _HELD.append(fd)
    os.symlink(f"/proc/{os.getpid()}/fd/{fd}", path)
    return os.fdopen(os.dup(fd), "wb")


def release() -> None:
    """Free every file `create` made (their symlinks dangle after)."""
    while _HELD:
        os.close(_HELD.pop())


def random_codes(rng: np.random.Generator, n: int, gc: float) -> np.ndarray:
    """n codes, C and G each gc / 2 of them, A and T each (1 - gc) / 2."""
    out = np.empty(n, np.uint8)
    t1 = int(round((1 - gc) / 2 * 65536))
    t3 = 65536 - t1
    for s in range(0, n, CHUNK):
        u = rng.integers(0, 65536, min(CHUNK, n - s), dtype=np.uint16)
        c = (u >= t1).view(np.uint8) + (u >= 32768).view(np.uint8)
        c += (u >= t3).view(np.uint8)
        out[s : s + u.size] = c
    return out


def spread(rng: np.random.Generator, lo: float, hi: float,
           n: int) -> np.ndarray:
    """n values evenly spaced over [lo, hi], in an order drawn from rng:
    every seed gets the same set of sizes, so seeds change the order of
    the work, not its amount."""
    return lo + (hi - lo) * (rng.permutation(n) + 0.5) / n


def substitute(codes: np.ndarray, rate, rng: np.random.Generator) -> None:
    """Replace each code, with probability `rate` (a scalar, or one rate a
    code), by one of the three others, in place."""
    n = codes.size
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        r = rate if np.isscalar(rate) else rate[s:e]
        hit = np.flatnonzero(rng.random(e - s, dtype=np.float32) < r) + s
        codes[hit] = (codes[hit] + rng.integers(1, 4, hit.size,
                                                dtype=np.uint8)) % 4


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def write_record(f, header: str, seq: np.ndarray) -> None:
    """One FASTA record of the uint8 letters `seq`, 80 a line."""
    f.write(f">{header}\n".encode())
    full = seq.size // 80 * 80
    body = np.empty((full // 80, 81), np.uint8)
    body[:, :80] = seq[:full].reshape(-1, 80)
    body[:, 80] = ord("\n")
    f.write(body.tobytes())
    if seq.size > full:
        f.write(seq[full:].tobytes() + b"\n")


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    return np.stack([(values // 10 ** d) % 10 + 48
                     for d in range(width - 1, -1, -1)],
                    axis=1).astype(np.uint8)


def fastq_rows(first: int, seqs: np.ndarray, qual: np.ndarray, mate: bytes,
               hap: np.ndarray, pos: np.ndarray,
               rc: np.ndarray) -> np.ndarray:
    """Fixed-width FASTQ records, one row each: '@r' + 9-digit index +
    mate, then the read's origin ' <haplotype>:<9-digit start>:<strand>',
    the letters, '+', the qualities."""
    n = seqs.shape[0]

    def const(b: bytes):
        return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))

    strand = np.where(rc, ord("-"), ord("+")).astype(np.uint8)[:, None]
    return np.ascontiguousarray(np.concatenate(
        [const(b"@r"), _digits(np.arange(first, first + n), 9), const(mate),
         const(b" "), _digits(hap, 1), const(b":"), _digits(pos, 9),
         const(b":"), strand, const(b"\n"), seqs, const(b"\n+\n"), qual,
         const(b"\n")], axis=1))
