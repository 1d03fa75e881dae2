"""Spectrum formatting and emission.

The port's copy of `findkmer_tpu/output.py`.  Output is always in
lexicographic k-mer order, which is ascending 2-bit-code order by
construction of the A=0,C=1,G=2,T=3 encoding; ordering, zero-suppression
and the separator are Config fields.

Decoding is vectorized: codes are expanded to an (n, k) base matrix with k
shifts, viewed as fixed-width byte strings, and joined in bounded-size
chunks; where the C library builds, `io.native.format_spectrum` formats a
chunk in one pass.  Spans (`utils.prof`): `write/threshold` is each
application of the count thresholds, `write/format` each chunk's
formatting, `write/io` each write of formatted bytes; the counter
`entries_written` adds the lines each chunk formats.

One loop writes every spectrum (`write_spectrum`): a finalized one is cut
into host chunks, a counter's `finalize_chunks` arrives in them, and each
chunk is thresholded, formatted and written in turn.
"""

from __future__ import annotations

from collections.abc import Iterator
from typing import IO

import numpy as np

from findkmer_torch.config import Config
from findkmer_torch.utils.prof import count, span

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def revcomp_codes_u64(codes, k: int) -> np.ndarray:
    """Vectorized reverse complement of uint64 2-bit k-mer codes.

    Complement = bitwise NOT over the 2k code bits (A<->T, C<->G are
    bit-complements in the A=0,C=1,G=2,T=3 encoding); reversal = reverse
    the 2-bit fields of the 64-bit word, then shift the k live fields
    back down."""
    x = np.bitwise_not(np.asarray(codes, dtype=np.uint64))
    m2 = np.uint64(0x3333333333333333)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = x.byteswap()
    return x >> np.uint64(64 - 2 * k)


def codes_to_kmer_bytes(codes: np.ndarray, k: int) -> np.ndarray:
    """(n,) integer codes -> (n,) numpy 'S{k}' array of ACGT strings."""
    codes = np.asarray(codes, dtype=np.uint64)
    out = np.empty((codes.shape[0], k), dtype=np.uint8)
    for j in range(k):
        out[:, j] = _BASES[
            ((codes >> np.uint64(2 * (k - 1 - j))) & np.uint64(3)).astype(
                np.int64
            )
        ]
    return np.ascontiguousarray(out).view(f"S{k}")[:, 0]


def _format_chunk(
    codes: np.ndarray, counts: np.ndarray, k: int, sep: bytes,
    counts_only: bool,
) -> bytes:
    count("entries_written", counts.shape[0])
    with span("write/format"):
        if not counts_only and len(sep) == 1:
            # one-pass C formatter (~10x the numpy string assembly); its
            # faults raise, never fall back unseen to the slow path
            from findkmer_torch.io import native

            if native.available():
                return native.format_spectrum(codes, counts, k, sep)
        counts_s = counts.astype("S")
        if counts_only:
            return b"\n".join(counts_s.tolist()) + b"\n"
        kmers = codes_to_kmer_bytes(codes, k)
        lines = np.char.add(np.char.add(kmers, sep), counts_s)
        return b"\n".join(lines.tolist()) + b"\n"


def _apply_count_thresholds(chunk, cfg: Config):
    """One (codes, counts) chunk's entries as they are written: KMC-style
    -ci/-cx (Config.min_count / max_count) drops the entries it filters,
    or with cfg.zeros sets their counts to 0 (they print as any other
    zero-count k-mer).  With zeros and canonical only the canonical code
    space is enumerated: a canonical table folds every count onto
    min(code, revcomp), so its other slots are structural, not observed
    zeros.  Counting itself stays exact."""
    codes, counts = chunk
    if cfg.zeros and cfg.canonical:
        m = codes <= revcomp_codes_u64(codes, cfg.k)
        codes, counts = codes[m], counts[m]
    lo, hi = cfg.min_count, cfg.max_count
    if lo <= 1 and hi == 0:
        return codes, counts
    m = counts >= lo
    if hi:
        m &= counts <= hi
    if cfg.zeros:
        return codes, np.where(m, counts, 0)
    return codes[m], counts[m]


def _whole_chunks(spectrum, cfg: Config, chunk: int = 1 << 20):
    """A finalized spectrum as (codes uint64, counts) host chunks in code
    order: sparse (codes, counts) cut as it is; a dense (4^k,) table's
    nonzero bins, or with cfg.zeros every bin."""
    if isinstance(spectrum, tuple):
        if cfg.zeros:
            raise ValueError(
                "zeros output is only supported for direct (dense) tables"
            )
        codes, counts = spectrum
        for s in range(0, codes.shape[0], chunk):
            yield codes[s : s + chunk], counts[s : s + chunk]
        return
    counts = np.asarray(spectrum)
    if cfg.zeros:
        for s in range(0, counts.shape[0], chunk):
            e = min(s + chunk, counts.shape[0])
            yield np.arange(s, e, dtype=np.uint64), counts[s:e]
        return
    (nz,) = np.nonzero(counts)
    for s in range(0, nz.shape[0], chunk):
        idx = nz[s : s + chunk]
        yield idx.astype(np.uint64), counts[idx]


def _blocks(chunks, cfg: Config, block: int = 1 << 20) -> Iterator[bytes]:
    """Formatted output blocks of host (codes, counts) chunks: each
    chunk thresholded (`write/threshold`), then formatted `block` entries
    at a time."""
    sep = cfg.sep.encode()
    for chunk in chunks:
        with span("write/threshold"):
            codes, counts = _apply_count_thresholds(chunk, cfg)
        for s in range(0, codes.shape[0], block):
            yield _format_chunk(codes[s : s + block], counts[s : s + block],
                                cfg.k, sep, cfg.out_counts_only)


def spectrum_chunks(
    spectrum, cfg: Config, chunk: int = 1 << 20
) -> Iterator[bytes]:
    """Yield formatted output blocks for a finalized spectrum.

    spectrum: dense np counts (4^k,) or sparse (codes uint64, counts).
    """
    return _blocks(_whole_chunks(spectrum, cfg, chunk), cfg, chunk)


def write_spectrum(f: IO[bytes], spectrum, cfg: Config) -> int:
    """Write a spectrum; returns bytes written.

    spectrum: a finalized one (dense np counts (4^k,) or sparse (codes
    uint64, counts)), or an iterator of host (codes uint64, counts)
    chunks in code order, such as a counter's `finalize_chunks`: each
    chunk is formatted and written before the next is drawn, so the
    write overlaps the pull of the chunks after it."""
    if not isinstance(spectrum, Iterator):
        spectrum = _whole_chunks(spectrum, cfg)
    n = 0
    for block in _blocks(spectrum, cfg):
        with span("write/io"):
            f.write(block)
        n += len(block)
    return n


def spectrum_to_text(spectrum, cfg: Config) -> str:
    return b"".join(spectrum_chunks(spectrum, cfg)).decode()
