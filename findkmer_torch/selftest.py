"""`findkmer_torch.cli selftest`: the deployment sanity check of the port.

Counterpart of `findkmer_tpu/selftest.py`, with its own copies of that
module's case builders: the synthetic input (`_make_input`), the
independent byte-at-a-time scalar counter (`_scalar_count`), the
spectrum-to-dict view (`_spectrum_dict`) and the CASES (k=4 dense, k=13
narrow sparse, k=21 canonical sparse).  Each case is counted end to end on the chosen torch
device through `findkmer_torch.pipeline.count_file` and diffed
bit-exactly against the scalar counter, so a bad install, a kernel that
miscounts on this card or a broken native library shows up as a FAIL
before any real data is touched.
"""

from __future__ import annotations

import os
import sys
import tempfile

from typing import Dict, Iterable, Tuple

import numpy as np

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _scalar_count(seqs: Iterable[str], k: int, canonical: bool
                  ) -> Dict[str, int]:
    """Independent reference: dict-of-strings byte-at-a-time counting
    (uppercase-fold, any non-ACGT byte breaks the window)."""
    counts: Dict[str, int] = {}
    for seq in seqs:
        s = seq.upper()
        n = len(s)
        i = 0
        while i + k <= n:
            w = s[i:i + k]
            if any(c not in _COMP for c in w):
                i += 1
                continue
            if canonical:
                rc = "".join(_COMP[c] for c in reversed(w))
                if rc < w:
                    w = rc
            counts[w] = counts.get(w, 0) + 1
            i += 1
    return counts


def _spectrum_dict(spectrum, k: int) -> Dict[str, int]:
    from findkmer_torch.output import codes_to_kmer_bytes

    if isinstance(spectrum, tuple):
        codes, counts = spectrum
    else:
        counts = np.asarray(spectrum)
        (codes,) = np.nonzero(counts)
        counts = counts[codes]
    kmers = codes_to_kmer_bytes(np.asarray(codes), k)
    return {
        w.decode(): int(n) for w, n in zip(kmers.tolist(), counts)
    }


def _make_input(rng) -> Tuple[str, list]:
    bases = np.array(list("ACGTacgt"))
    recs = []
    for ln in (4000, 2500):
        arr = bases[rng.integers(0, 8, ln)].astype("U1")
        arr[rng.random(ln) < 0.02] = "N"
        recs.append("".join(arr))
    # repeat-heavy + homopolymer record: counts far above 1 and a hot
    # k-mer
    rep = recs[0][:900]
    recs.extend([rep] * 3)
    recs.append("A" * 600)
    text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(recs))
    return text, recs


CASES = (
    dict(k=4, canonical=False),    # dense table
    dict(k=13, canonical=False),   # narrow sparse (int32 codes)
    dict(k=21, canonical=True),    # wide sparse + canonical fold
)


def run(args, row_sort: str = "auto", dense_kernel: str = "fused") -> int:
    """CLI adapter: count each case end to end, diff vs the scalar
    reference, print one line per case and a summary; rc 1 on any
    mismatch."""
    import torch

    from findkmer_torch import Config, pipeline
    from findkmer_torch.device import resolve_device

    device = resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rng = np.random.default_rng(args.seed)
    text, recs = _make_input(rng)
    print(f"device: {device} ({name}); counting with devices=1")
    failures = 0
    with tempfile.TemporaryDirectory(prefix="findkmer_selftest_") as tmp:
        path = os.path.join(tmp, "selftest.fa")
        with open(path, "w") as f:
            f.write(text)
        for case in CASES:
            cfg = Config(chunk_len=1024, batch_rows=2, **case)
            spectrum = pipeline.count_file(path, cfg, device,
                                           row_sort=row_sort,
                                           dense_kernel=dense_kernel)
            got = _spectrum_dict(spectrum, cfg.k)
            want = _scalar_count(recs, cfg.k, cfg.canonical)
            tag = (f"k={cfg.k}"
                   + (" canonical" if cfg.canonical else "")
                   + f" [{cfg.resolved_table_mode}]")
            if got == want:
                print(f"  PASS {tag}: {len(want)} distinct, "
                      f"{sum(want.values())} total, max count "
                      f"{max(want.values())}")
            else:
                failures += 1
                bad = {w for w in set(want) | set(got)
                       if want.get(w) != got.get(w)}
                sample = [(w, want.get(w), got.get(w))
                          for w in sorted(bad)[:3]]
                print(f"  FAIL {tag}: {len(bad)} mismatches, e.g. "
                      f"{sample}", file=sys.stderr)
    if failures:
        print(f"selftest FAILED ({failures}/{len(CASES)} cases)",
              file=sys.stderr)
        return 1
    print(f"selftest OK ({len(CASES)}/{len(CASES)} cases bit-exact)")
    return 0
