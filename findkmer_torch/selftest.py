"""`findkmer_torch.cli selftest`: the deployment sanity check of the port.

Counterpart of `findkmer_tpu/selftest.py`, whose jax-free parts it reuses:
the synthetic input (`_make_input`), the independent byte-at-a-time
scalar counter (`_scalar_count`), the spectrum-to-dict view
(`_spectrum_dict`) and the CASES (k=4 dense, k=13 narrow sparse, k=21
canonical sparse).  Each case is counted end to end on the chosen torch
device through `findkmer_torch.pipeline.count_file` and diffed
bit-exactly against the scalar counter, so a bad install, a kernel that
miscounts on this card or a broken native library shows up as a FAIL
before any real data is touched.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from findkmer_tpu.selftest import (
    CASES,
    _make_input,
    _scalar_count,
    _spectrum_dict,
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
