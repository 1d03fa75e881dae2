"""`c2_roofline`: C2's frozen byte formula, its kernel pattern, the share's
arithmetic, and no hook where the program has no C2."""

import importlib
import importlib.util

import pytest
import torch

from kmerbench import harness, metrics, trace
from kmerbench.peaks import HBM_BYTES_PER_S


def test_c2_bytes_keys_counts_and_totals_once():
    hook = metrics.load("c2_roofline").HOOKS[0]
    assert hook[:4] == ("c2", "findkmer_torch.ops.cuda.rle_kernel",
                        "rle_rows_cuda", "rle_rows_cuda")
    nbytes = hook[4]
    keys = torch.zeros(1024, 2048, dtype=torch.int64)
    cnt = torch.zeros(1024, 2048, dtype=torch.int32)
    # counted: keys and counts in, the totals over the counts
    assert nbytes((keys, cnt), {}, cnt) == 1024 * 2048 * (8 + 4 + 4)
    assert nbytes((keys,), {"cnt": cnt}, cnt) == 1024 * 2048 * 16
    # implicit: keys in, the totals out
    out = torch.zeros(1024, 2048, dtype=torch.int32)
    assert nbytes((keys, None, torch.int32), {}, out) == 1024 * 2048 * 12


def _ev(name, cat, t0_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": t0_us, "dur": dur_us}


def test_c2_share_reads_its_kernels_alone():
    tr = trace.from_events([
        _ev("kmerbench.job", "user_annotation", 0, 1000),
        _ev("void (anonymous namespace)::rle_rows<long, int, true>(long "
            "const*, int const*, int*, long, long, bool, unsigned long*)",
            "kernel", 100, 100),
        _ev("void (anonymous namespace)::rle_rows<int, int, false>(int "
            "const*)", "kernel", 300, 100),
        _ev("void at::native::tensor_kernel_scan_innermost_dim_with_indices"
            "<long, long>(long*)", "kernel", 500, 300),
        _ev("void (anonymous namespace)::sort_tiles<long, int, 10>(long*)",
            "kernel", 850, 100),
    ])
    reader = metrics.load("c2_roofline")
    r = harness.Reading(1.0, [], [("c2", 100e-6 * HBM_BYTES_PER_S)], [], tr)
    assert reader.read(r) == pytest.approx(50.0)  # 100 us of 200
    r = harness.Reading(1.0, [], [("k3", 1e9)], [], tr)
    assert reader.read(r) is None  # nothing of C2 launched


def test_no_hook_without_the_wrapper(monkeypatch):
    """The parent of C2 runs the cell too: no hook, nothing read."""
    mod = metrics.load("c2_roofline")
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name.endswith("rle_kernel") else real(
            name, *a))
    try:
        assert importlib.reload(mod).HOOKS == []
    finally:
        monkeypatch.undo()
        importlib.reload(mod)
    assert len(mod.HOOKS) == 1
