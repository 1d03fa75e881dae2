"""Spectrum-file parsing (host side), the part that read filtering needs.

The port's copy of the parts of `findkmer_tpu/spectra.py` that
`filter.FilterSpec.load` calls: the C parser of a sorted spectrum
(`_parse_binary`), its dict fallback for other inputs (`read_spectrum`),
k from the first line (`_infer_k`) and the canonical fold
(`canonize_runs`).  The reverse complement of codes is
`output.revcomp_codes_u64`.  The rest of the module (merge, diff, the set
operations) comes with the spectrum subcommands.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from findkmer_torch.io import native
from findkmer_torch.io.fasta import open_maybe_gzip
from findkmer_torch.output import revcomp_codes_u64


def _dict_max() -> int:
    """Entry cap for the dict fallback path: a chromosome-scale UNSORTED
    input would otherwise exhaust memory silently (a 33M-key str dict is
    already several GB).  FINDKMER_DICT_MAX overrides."""
    try:
        return int(os.environ.get("FINDKMER_DICT_MAX", str(1 << 25)))
    except ValueError:
        return 1 << 25


def read_spectrum(path, sep: str = "\t") -> Dict[str, int]:
    """Parse a KMER<sep>COUNT file (plain or gzipped) into a dict.

    This is the small/unsorted-input fallback; it refuses inputs past
    ~33M distinct k-mers (_dict_max) with a "sort it first" error."""
    out: Dict[str, int] = {}
    cap = _dict_max()
    sep_b = sep.encode()
    f, _ = open_maybe_gzip(path)
    with f:
        for line_no, raw in enumerate(f, 1):
            raw = raw.rstrip(b"\r\n")
            if not raw:
                continue
            try:
                kmer_b, cnt = raw.split(sep_b)
                kmer = kmer_b.decode()
                out[kmer] = out.get(kmer, 0) + int(cnt)
            except (ValueError, UnicodeDecodeError) as e:
                line = raw.decode("ascii", "replace")
                raise ValueError(
                    f"{path}:{line_no}: malformed spectrum line {line!r}"
                ) from e
            if len(out) > cap:
                raise ValueError(
                    f"{path}: more than {cap} distinct k-mers on the "
                    "in-memory dict path (input is unsorted or exotic); "
                    "normalize it first with `findkmer sort` so the "
                    "O(buffer) streaming path applies, or raise "
                    "FINDKMER_DICT_MAX"
                )
    return out


def _infer_k(path, sep_b: bytes) -> int | None:
    """k from the first data line of a spectrum file.

    None = no C fast path: the file is empty OR its k-mers exceed the
    2-bit-code range (k > 31)."""
    f, _ = open_maybe_gzip(path)
    with f:
        head = f.read(4096)
    for line in head.split(b"\n"):
        if line.strip():
            k = len(line.rstrip(b"\r").rsplit(sep_b, 1)[0])
            return k if 1 <= k <= 31 else None
    return None


def _parse_binary(path, k: int, sep_b: bytes):
    """One spectrum file -> (codes u64, counts i64) via the C parser.

    Returns None when the native library is missing or the input is
    exotic (gzipped, unsorted, lowercase, blank lines): callers fall back
    to the dict path."""
    if not native.available():
        return None
    size = os.path.getsize(path)
    if size == 0:
        return (np.empty(0, np.uint64), np.empty(0, np.int64))
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            return None  # gzipped: the line path handles it
        f.seek(0)
        buf = np.empty(size, np.uint8)
        got = f.readinto(memoryview(buf))
    return native.parse_spectrum(buf[:got], k, sep_b)


def canonize_runs(codes, counts, k: int):
    """Fold a (codes, counts) spectrum to canonical (revcomp-min) form.

    Output is sorted by canonical code with counts of a k-mer and its
    reverse complement summed: the spectrum `count --canonical` would
    have produced from the same input."""
    codes = np.asarray(codes, dtype=np.uint64)
    if codes.size == 0:
        return codes, np.asarray(counts, dtype=np.int64)
    canon = np.minimum(codes, revcomp_codes_u64(codes, k))
    order = np.argsort(canon, kind="stable")
    c = canon[order]
    n = np.asarray(counts, dtype=np.int64)[order]
    starts = np.empty(c.size, dtype=bool)
    starts[0] = True
    np.not_equal(c[1:], c[:-1], out=starts[1:])
    idx = np.flatnonzero(starts)
    return c[idx], np.add.reduceat(n, idx)
