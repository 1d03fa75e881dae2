"""Bottom-s MinHash sketches of k-mer sets (Mash/sourmash tool class).

The port's copy of `findkmer_tpu/sketch.py`, under the same names and in
the same file format, so either package reads the other's sketches.  A
sketch is the s smallest values of a 64-bit hash over the sample's
DISTINCT k-mer codes (bottom-s MinHash).  Jaccard between two samples is
estimated by the Mash estimator: merge the two hash sets, keep the
s' = min(s_a, s_b, |union|) smallest union hashes, and count how many of
those appear in both sketches; j ~ shared/s'.  The Mash distance is
-ln(2j/(1+j))/k, as in `spectra.similarity_spectra`.

The hash is the splitmix64 finalizer over the 2-bit k-mer code (not
MurmurHash over the string as Mash uses: the files are findkmer's own
format, versioned below, not .msh-compatible).  Hashing the code keeps
the hot path one vectorized numpy pass and makes canonical folding
exact: fold codes first, then hash.

`sketch_sequences` counts its inputs with `api.count` on the device it
is given (cuda by default; cuda without a card raises); everything else
here is host work.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from findkmer_torch import spectra
from findkmer_torch.io.encode import LUT as lut
from findkmer_torch.io.fasta import open_maybe_gzip

SKETCH_FORMAT = "findkmer/sketch/v1"
DEFAULT_S = 1000

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def hash_codes_u64(codes) -> np.ndarray:
    """splitmix64 finalizer over uint64 k-mer codes (vectorized).

    A bijection on uint64, so distinct codes give distinct hashes —
    bottom-s over hashes is a uniform random sample of the distinct
    k-mer set without collision corrections."""
    z = np.asarray(codes, dtype=np.uint64) + _GOLDEN
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def sketch_codes(codes, s: int) -> np.ndarray:
    """Sorted bottom-s hash values of the given (not necessarily unique)
    codes."""
    s = int(s)
    if s < 1:
        # s=0 would make every pair of samples compare as identical
        # (empty vs empty -> jaccard 1.0); negative s would silently
        # drop the LARGEST hashes via the h[:s] slice
        raise ValueError(f"sketch size s must be >= 1, got {s}")
    # sort, then drop repeats (codes shared by several inputs): the same
    # values as np.unique, whose hash-based path in newer numpy was most
    # of a sketch's time at millions of codes
    h = np.sort(hash_codes_u64(codes))
    if h.size:
        h = h[np.concatenate(([True], h[1:] != h[:-1]))]
    return h[:s]


def _codes_of_spectrum_file(path, sep: str) -> tuple:
    """(k, distinct uint64 codes) of a spectrum file.

    Rides the C parser on clean sorted files; the line path handles
    gzip/unsorted/lowercase inputs (order-insensitive: hashes are
    re-sorted by the sketch anyway, so no sort check applies)."""
    sep_b = sep.encode()
    k = spectra._infer_k(path, sep_b)
    if k is not None and k <= 31:
        parsed = spectra._parse_binary(path, k, sep_b)
        if parsed is not None:
            return k, parsed[0]
    # Line fallback: batch k-mer bytes, LUT to bases, pack to codes
    # (the shared ACGT/acgt table; non-ACGT maps > 3)
    kk: Optional[int] = None
    chunks: List[np.ndarray] = []
    batch: List[bytes] = []

    def _flush():
        if not batch:
            return
        arr = lut[np.frombuffer(b"".join(batch), np.uint8)]
        arr = arr.reshape(len(batch), kk)
        if (arr > 3).any():
            bad = batch[int(np.argmax((arr > 3).any(axis=1)))]
            raise ValueError(f"non-ACGT k-mer in {path!r}: {bad!r}")
        w = (np.uint64(4) ** np.arange(kk - 1, -1, -1, dtype=np.uint64))
        chunks.append(arr.astype(np.uint64) @ w)
        batch.clear()

    for kmer, _cnt in spectra._spectrum_lines(path, sep_b):
        if kk is None:
            kk = len(kmer)
            if kk > 31:
                raise ValueError(
                    f"sketch supports k <= 31, got k={kk} in {path!r}"
                )
        elif len(kmer) != kk:
            raise ValueError(f"mixed k-mer lengths in {path!r}")
        batch.append(kmer)
        if len(batch) >= 65536:
            _flush()
    _flush()
    if kk is None:
        return 0, np.empty(0, np.uint64)
    return kk, np.concatenate(chunks) if chunks else np.empty(0, np.uint64)


def sketch_spectrum_file(
    path, s: int = DEFAULT_S, sep: str = "\t", canonical: bool = False,
    name: Optional[str] = None,
) -> Dict[str, object]:
    """Sketch the distinct k-mer set of a spectrum file.

    canonical=True folds codes to revcomp-min before hashing —
    idempotent on already-canonical spectra (min(c, rc(c)) == c), so
    plain and canonical inputs mix safely, like similarity_spectra."""
    k, codes = _codes_of_spectrum_file(path, sep)
    if canonical and codes.size:
        codes = np.minimum(codes, spectra.revcomp_codes_u64(codes, k))
    return _make(k, s, canonical, sketch_codes(codes, s),
                 name if name is not None else str(path))


def sketch_sequences(
    inputs: Sequence[str], k: int, s: int = DEFAULT_S,
    canonical: bool = False, name: Optional[str] = None,
    device="cuda", **config_overrides,
) -> Dict[str, object]:
    """Sketch FASTA/FASTQ/SAM/BAM input(s) as ONE sample (same multi-
    input semantics as `findkmer count`): counts k-mers on `device` (a
    name or a torch.device; cuda without a card raises), then hashes the
    finalized distinct-code set.  Exact bottom-s: no streaming
    approximation on top of the estimator itself."""
    from findkmer_torch import api  # imports torch

    sp = api.count(list(inputs), k, canonical=canonical, device=device,
                   **config_overrides)
    if sp._dense is not None:
        codes = np.flatnonzero(sp._dense).astype(np.uint64)
    else:
        codes = sp._codes
    return _make(k, s, canonical, sketch_codes(codes, s),
                 name if name is not None else ",".join(map(str, inputs)))


def _make(k, s, canonical, hashes, name) -> Dict[str, object]:
    return {
        "format": SKETCH_FORMAT,
        "name": name,
        "k": int(k),
        "s": int(s),
        "canonical": bool(canonical),
        "n_hashes": int(hashes.size),
        "hashes": [format(int(h), "016x") for h in hashes],
    }


def write_sketch(sketch: Dict[str, object], f) -> None:
    """Serialize to an open BINARY file (JSON, one object)."""
    f.write(json.dumps(sketch, indent=1).encode())


def read_sketch(path) -> Dict[str, object]:
    f, own = open_maybe_gzip(path)
    try:
        sk = json.loads(f.read().decode())
    finally:
        if own:
            f.close()
    if not (isinstance(sk, dict) and sk.get("format") == SKETCH_FORMAT):
        raise ValueError(f"{path!r} is not a {SKETCH_FORMAT} file")
    return sk


def is_sketch_file(path) -> bool:
    """True when the (possibly gzipped) file head looks like a v1 sketch."""
    try:
        f, own = open_maybe_gzip(path)
    except OSError:
        return False
    try:
        head = f.read(256).decode("ascii", "replace")
    except OSError:
        return False
    finally:
        if own:
            f.close()
    return head.lstrip().startswith("{") and SKETCH_FORMAT in head


def _hashes(sk: Dict[str, object]) -> np.ndarray:
    return np.array([int(h, 16) for h in sk["hashes"]], dtype=np.uint64)


def compare_sketches(
    a: Dict[str, object], b: Dict[str, object]
) -> Dict[str, object]:
    """Mash-estimator comparison of two sketches.

    Requires matching k and canonical flag (a canonical and a plain
    sketch hash disjoint code spaces — the estimate would be
    meaningless, so it's an error, mirroring merge's strictness)."""
    if a["k"] != b["k"]:
        raise ValueError(f"sketch k mismatch: {a['k']} vs {b['k']}")
    if bool(a["canonical"]) != bool(b["canonical"]):
        raise ValueError(
            "cannot compare a canonical sketch with a plain one; "
            "re-sketch with matching --canonical"
        )
    ha, hb = _hashes(a), _hashes(b)
    union = np.union1d(ha, hb)
    sprime = min(int(min(a["s"], b["s"])), int(union.size))
    sub = union[:sprime]
    shared = int(np.count_nonzero(np.isin(sub, ha) & np.isin(sub, hb)))
    j = shared / sprime if sprime else (1.0 if ha.size == hb.size == 0 else 0.0)
    k = int(a["k"])
    if j > 0 and k:
        mash = max(0.0, -math.log(2 * j / (1 + j)) / k)
    elif ha.size == 0 and hb.size == 0:
        mash = 0.0
    else:
        mash = 1.0
    return {
        "k": k,
        "canonical": bool(a["canonical"]),
        "name_a": a.get("name", ""),
        "name_b": b.get("name", ""),
        "hashes_a": int(ha.size),
        "hashes_b": int(hb.size),
        "sample_size": sprime,
        "shared": shared,
        "jaccard": j,
        "mash_distance": mash,
    }
