"""Spectrum formatting and emission.

The port's copy of `findkmer_tpu/output.py`.  Output is always in
lexicographic k-mer order, which is ascending 2-bit-code order by
construction of the A=0,C=1,G=2,T=3 encoding; ordering, zero-suppression
and the separator are Config fields.

Decoding is vectorized: codes are expanded to an (n, k) base matrix with k
shifts, viewed as fixed-width byte strings, and joined in bounded-size
chunks; where the C library builds, `io.native.format_spectrum` formats a
chunk in one pass.
"""

from __future__ import annotations

from typing import IO, Iterator

import numpy as np

from findkmer_torch.config import Config

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
    if not counts_only and len(sep) == 1:
        # one-pass C formatter (~10x the numpy string assembly)
        try:
            from findkmer_torch.io import native

            if native.available():
                return native.format_spectrum(codes, counts, k, sep)
        except Exception:
            pass
    counts_s = counts.astype("S")
    if counts_only:
        return b"\n".join(counts_s.tolist()) + b"\n"
    kmers = codes_to_kmer_bytes(codes, k)
    lines = np.char.add(np.char.add(kmers, sep), counts_s)
    return b"\n".join(lines.tolist()) + b"\n"


def _apply_count_thresholds(spectrum, cfg: Config):
    """KMC-style -ci/-cx output filter (Config.min_count / max_count).

    Sparse spectra drop filtered entries; dense spectra zero them (so
    they fall out of the nonzero scan; with zeros=True they print as
    any other zero-count k-mer).  Counting itself stays exact."""
    lo, hi = cfg.min_count, cfg.max_count
    if lo <= 1 and hi == 0:
        return spectrum
    if isinstance(spectrum, tuple):
        codes, counts = spectrum
        m = counts >= lo
        if hi:
            m &= counts <= hi
        return codes[m], counts[m]
    counts = np.asarray(spectrum)
    m = counts >= lo
    if hi:
        m &= counts <= hi
    return np.where(m, counts, 0)


def spectrum_chunks(
    spectrum, cfg: Config, chunk: int = 1 << 20
) -> Iterator[bytes]:
    """Yield formatted output blocks for a finalized spectrum.

    spectrum: dense np counts (4^k,) or sparse (codes uint64, counts).
    """
    sep = cfg.sep.encode()
    k = cfg.k
    spectrum = _apply_count_thresholds(spectrum, cfg)
    if isinstance(spectrum, tuple):
        codes, counts = spectrum
        if cfg.zeros:
            raise ValueError(
                "zeros output is only supported for direct (dense) tables"
            )
        for s in range(0, codes.shape[0], chunk):
            e = min(s + chunk, codes.shape[0])
            yield _format_chunk(
                codes[s:e], counts[s:e], k, sep, cfg.out_counts_only
            )
        return

    counts = np.asarray(spectrum)
    if cfg.zeros:
        for s in range(0, counts.shape[0], chunk):
            e = min(s + chunk, counts.shape[0])
            codes = np.arange(s, e, dtype=np.uint64)
            cnts = counts[s:e]
            if cfg.canonical:
                # canonical tables fold every count onto min(code,
                # revcomp): the zero interleave enumerates only that
                # canonical code space (non-canonical slots are
                # structural, not observed-zero)
                m = codes <= revcomp_codes_u64(codes, k)
                codes, cnts = codes[m], cnts[m]
            yield _format_chunk(
                codes,
                cnts,
                k,
                sep,
                cfg.out_counts_only,
            )
    else:
        (nz,) = np.nonzero(counts)
        for s in range(0, nz.shape[0], chunk):
            e = min(s + chunk, nz.shape[0])
            idx = nz[s:e]
            yield _format_chunk(
                idx.astype(np.uint64), counts[idx], k, sep,
                cfg.out_counts_only,
            )


def write_spectrum_streaming(f: IO[bytes], chunk_iter, cfg: Config) -> int:
    """Write a sparse spectrum from an iterator of (codes, counts) host
    chunks (globally sorted, e.g. KmerCounter.finalize_chunks).

    Each chunk is formatted and written while later chunks' D2H
    transfers are still in flight — the write tail overlaps the pull
    instead of waiting for the whole spectrum.  Returns bytes written."""
    if cfg.zeros:
        raise ValueError(
            "zeros output is only supported for direct (dense) tables"
        )
    sep = cfg.sep.encode()
    n = 0
    block = 1 << 20
    for chunk in chunk_iter:
        codes, counts = _apply_count_thresholds(chunk, cfg)
        for s in range(0, codes.shape[0], block):
            e = min(s + block, codes.shape[0])
            b = _format_chunk(
                codes[s:e], counts[s:e], cfg.k, sep, cfg.out_counts_only
            )
            f.write(b)
            n += len(b)
    return n


def write_spectrum(f: IO[bytes], spectrum, cfg: Config) -> int:
    """Write the full spectrum; returns bytes written."""
    n = 0
    for block in spectrum_chunks(spectrum, cfg):
        f.write(block)
        n += len(block)
    return n
