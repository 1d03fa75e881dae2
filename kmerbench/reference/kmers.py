"""The plain reference: k-mer spectra of FASTA and FASTQ files in plain
NumPy and PyTorch, on the card or the CPU, and the program's text formats
worked out again from them.  Nothing of the program is imported.

Semantics (the contract of `oracle/scalar.py`): every length-k window of
each record, stride 1; A, C, G, T in either case are bases, any other
letter (N, IUPAC codes) resets the window; windows never cross records;
canonical counting keeps min(code, reverse complement); counts are exact.
FASTA: '>' lines start records, line breaks and other ASCII whitespace
inside the sequence are dropped.  FASTQ: four lines a record, the second
the sequence.  Output: `KMER<TAB>COUNT` lines in code order (A<C<G<T).

Controls (`variant`): the same spectrum through one guarantee broken at
the next narrower width, for showing that the comparison fails them:
"fingerprint32" keys every k-mer by a 32-bit hash of its 64-bit code, so
colliding k-mers share one count (a hash table with 32-bit keys);
"count16" saturates counts at the int16 maximum.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

WINDOW_CHUNK = 1 << 26  # bases a device pass of the window extraction
LINE_CHUNK = 1 << 23  # lines formatted a device pass
_WS = np.frombuffer(b" \t\r\n\v\f", np.uint8)


def _lines(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(start, end) byte offsets of every line, newline excluded."""
    nl = np.flatnonzero(data == ord("\n"))
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [data.size]])
    keep = starts < ends
    return starts[keep], ends[keep]


def read_sequences(path: str) -> np.ndarray:
    """The file's sequence letters, records joined by one b'>' (a letter
    that is no base, so no window crosses it)."""
    data = np.fromfile(path, np.uint8)
    if data.size == 0:
        return data
    starts, ends = _lines(data)
    if data[0] == ord("@"):
        if starts.size % 4:
            raise ValueError(f"{path}: not a four-line FASTQ file")
        sep = np.zeros(data.size, bool)
        sep[starts[0::4]] = True
        keep = _inside(data.size, starts[1::4], ends[1::4]) | sep
        return np.where(sep, ord(">"), data)[keep]
    header = data[starts] == ord(">")
    first = np.zeros(data.size, bool)
    first[starts[header]] = True
    keep = ~_inside(data.size, starts[header], ends[header])
    keep &= ~np.isin(data, _WS)
    return data[keep | first]


def _inside(n: int, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Mask of the bytes inside the disjoint [start, end) spans."""
    mark = np.zeros(n + 1, np.int8)
    mark[starts] = 1
    mark[ends] -= 1
    return np.cumsum(mark[:-1], dtype=np.int8) > 0


def _lut(device) -> torch.Tensor:
    lut = torch.full((256,), 4, dtype=torch.uint8)
    for code, letters in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
        for c in letters:
            lut[c] = code
    return lut.to(device)


def window_codes(seq: np.ndarray, k: int, canonical: bool,
                 device) -> torch.Tensor:
    """int64 codes of the valid windows of `seq`, in order."""
    lut = _lut(device)
    out = []
    for s in range(0, max(seq.size - k + 1, 0), WINDOW_CHUNK):
        piece = torch.from_numpy(seq[s : s + WINDOW_CHUNK + k - 1]).to(device)
        b = lut[piece.long()].long()
        n = b.numel() - k + 1
        bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                         torch.cumsum((b == 4).long(), 0)])
        valid = (bad[k:] - bad[:n]) == 0
        fwd = torch.zeros(n, dtype=torch.int64, device=device)
        rc = torch.zeros(n, dtype=torch.int64, device=device)
        for j in range(k):
            base = b[j : j + n] & 3
            fwd = (fwd << 2) | base
            rc = rc | ((3 - base) << (2 * j))
        code = torch.minimum(fwd, rc) if canonical else fwd
        out.append(code[valid])
        del b, bad, valid, fwd, rc, code
    if not out:
        return torch.empty(0, dtype=torch.int64, device=device)
    return torch.cat(out)


def spectrum(paths: List[str], k: int, canonical: bool, device,
             variant: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted distinct codes, counts) of every window of the files,
    counted as one input; `variant` one of the module's controls."""
    codes = torch.cat([window_codes(read_sequences(p), k, canonical, device)
                       for p in paths])
    codes, _ = torch.sort(codes)
    codes, counts = torch.unique_consecutive(codes, return_counts=True)
    if variant == "fingerprint32":
        counts = _shared_counts(codes, counts)
    elif variant == "count16":
        counts = counts.clamp(max=torch.iinfo(torch.int16).max)
    elif variant != "exact":
        raise ValueError(f"unknown reference variant {variant!r}")
    return codes, counts


def fingerprint32(codes: torch.Tensor) -> torch.Tensor:
    """A 32-bit hash of each code: the high half of a 64-bit
    multiplicative hash (int64 arithmetic wraps)."""
    h = codes * -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
    return (h >> 32) & 0xFFFFFFFF


def _shared_counts(codes: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Each k-mer's count replaced by the total of its 32-bit
    fingerprint's k-mers."""
    fp = fingerprint32(codes)
    fps, order = torch.sort(fp)
    keys, inverse = torch.unique_consecutive(fps, return_inverse=True)
    totals = torch.zeros(keys.numel(), dtype=counts.dtype, device=codes.device)
    totals.index_add_(0, inverse, counts[order])
    out = torch.empty_like(counts)
    out[order] = totals[inverse]
    return out


def _digits(counts: torch.Tensor) -> torch.Tensor:
    nd = torch.ones_like(counts)
    p = 10
    while p <= int(counts.max()):
        nd += (counts >= p).long()
        p *= 10
    return nd


def tsv_pieces(codes: torch.Tensor, counts: torch.Tensor,
               k: int) -> Iterator[np.ndarray]:
    """The spectrum's `KMER<TAB>COUNT` lines as host uint8 pieces."""
    letters = torch.tensor(list(b"ACGT"), dtype=torch.uint8,
                           device=codes.device)
    for s in range(0, codes.numel(), LINE_CHUNK):
        c = codes[s : s + LINE_CHUNK]
        n = counts[s : s + LINE_CHUNK].long()
        nd = _digits(n)
        width = k + 2 + nd
        off = torch.cumsum(width, 0) - width
        out = torch.empty(int(width.sum()), dtype=torch.uint8,
                          device=codes.device)
        for j in range(k):
            out[off + j] = letters[(c >> (2 * (k - 1 - j))) & 3]
        out[off + k] = ord("\t")
        for d in range(int(nd.max())):
            m = nd > d
            power = 10 ** (nd[m] - 1 - d)
            out[off[m] + k + 1 + d] = ((n[m] // power) % 10 + 48).to(
                torch.uint8)
        out[off + width - 1] = ord("\n")
        yield out.cpu().numpy()


def histogram_lines(counts: torch.Tensor, max_count: int) -> bytes:
    """`m<TAB>h[m]` for m = 1..max_count, multiplicities above max_count
    in its bin (the program's `histo` without --nonzero-only)."""
    h = torch.bincount(counts.clamp(max=max_count), minlength=max_count + 1)
    h = h.cpu().numpy()
    return "".join(f"{m}\t{int(h[m])}\n"
                   for m in range(1, max_count + 1)).encode()
