"""K1: the window-code histogram as a hand-written CUDA kernel.

Counterpart of `findkmer_tpu/ops/pallas/histogram_kernel.py`
(`histogram_pallas`, `add_counts_pallas`).  The kernel is
`findkmer_torch/csrc/histogram.cu`; its design notes are there.  It is
built with nvcc at first use (`_build.py`) and called through ctypes.

`histogram_cuda` launches the kernel for CUDA tensors.  For CPU tensors,
and only for those, it runs the plain twin `histogram_reference`: the
port's counterpart of the Pallas kernel's `interpret=True`.  A build or
launch failure raises; nothing falls back.

`histogram_cuda.launches` counts the kernel's launches (never the
twin's), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from findkmer_torch.ops import window as window_ops

MAX_K = 10
# the constants of csrc/bins.cuh that the wrappers choose by
SHARED_MAX_K = 9  # the largest k with block-private shared-memory bins
SMALL_MAX_K = 6   # up to here the private bins are 16 KiB at most: always
# k = 7..9: private bins from this many windows for each of the 4^k bins.
# A launch with private bins zeroes and flushes one table a block (64 or
# 128 KiB) whatever it counted, so it gains only where every SM counts many
# times more windows than a table has bins; below, one atomic a window on
# the L2-resident table is faster (chip_smoke.py times both sides:
# `threshold` lines).
PRIVATE_MIN_WINDOWS_PER_BIN = 64


def private_bins(k: int, windows: int) -> bool:
    """Whether a batch of `windows` windows is counted in block-private
    shared-memory bins (else with atomics on the global table)."""
    if k <= SMALL_MAX_K:
        return True
    return (k <= SHARED_MAX_K
            and windows >= PRIVATE_MIN_WINDOWS_PER_BIN * 4 ** k)


def histogram_reference(
    codes: torch.Tensor, valid: torch.Tensor, k: int
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (4^k,) int32 histogram."""
    return torch.bincount(
        codes[valid.bool()], minlength=4 ** k
    ).to(torch.int32)


def _check(codes: torch.Tensor, valid: torch.Tensor, k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"histogram kernel needs 1 <= k <= {MAX_K}, got {k}")
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if codes.shape != valid.shape:
        raise ValueError(
            f"codes {tuple(codes.shape)} and valid {tuple(valid.shape)} "
            "differ in shape"
        )
    if codes.device != valid.device:
        raise ValueError(
            f"codes on {codes.device} but valid on {valid.device}"
        )
    if not (codes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("codes and valid must be contiguous")


def check_out(out: torch.Tensor, k: int, dev: torch.device) -> None:
    """Raise unless `out` is a table a kernel can add into in place."""
    if (out.dtype != torch.int32 or out.shape != (4 ** k,)
            or out.device != dev or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous int32 ({4 ** k},) tensor on {dev}, "
            f"got {out.dtype} {tuple(out.shape)} on {out.device}"
        )


def histogram_cuda(
    codes: torch.Tensor, valid: torch.Tensor, k: int,
    *, shared: bool | None = None, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, W) int32 codes + validity -> (4^k,) int32 histogram of the
    valid codes.  Launches the CUDA kernel for CUDA tensors; CPU tensors
    take the plain twin.

    `shared` picks the kernel's block-private shared-memory bins
    (k <= 9) or its atomics on the global table; None takes
    `private_bins(k, windows)`.  Both give the same counts; the choice
    exists so the two can be held against each other on the card.

    `out`, an int32 (4^k,) tensor on the codes' device, is added to in
    place and returned, instead of a fresh histogram."""
    _check(codes, valid, k)
    if shared is None:
        shared = private_bins(k, codes.numel())
    elif shared and k > SHARED_MAX_K:
        raise ValueError(
            f"the shared-memory histogram needs k <= {SHARED_MAX_K}, got {k}"
        )
    dev = codes.device
    if out is not None:
        check_out(out, k, dev)
    if dev.type == "cpu":
        hist = histogram_reference(codes, valid, k)
        return hist if out is None else out.add_(hist)
    if dev.type != "cuda":
        raise ValueError(f"histogram kernel runs on cuda or cpu, not {dev}")
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
    if out is None:
        out = torch.zeros(4 ** k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fk_histogram(
            codes.data_ptr(), valid.data_ptr(), codes.numel(),
            out.data_ptr(), k, int(shared),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.fk_cuda_error_string(err).decode()
        raise RuntimeError(
            f"histogram kernel launch failed: CUDA error {err} ({msg})"
        )
    histogram_cuda.launches += 1
    return out


histogram_cuda.launches = 0


def add_counts_cuda(
    rows: torch.Tensor, table: torch.Tensor, k: int, canonical: bool
) -> torch.Tensor:
    """table += histogram of all valid windows in rows (B, R) uint8.

    Window extraction runs as plain tensor ops (ops/window.py); binning
    runs in the kernel, which adds into an int32 `table` itself (an int64
    table takes the int32 delta of one batch, which cannot overflow)."""
    codes, valid = window_ops.window_codes(rows, k, canonical)
    if table.dtype == torch.int32 and table.is_contiguous():
        return histogram_cuda(codes, valid, k, out=table)
    table += histogram_cuda(codes, valid, k)
    return table
