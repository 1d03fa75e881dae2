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
SHARED_MAX_K = 6  # the largest k whose 4^k int32 bins fit the shared kernel


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


def histogram_cuda(
    codes: torch.Tensor, valid: torch.Tensor, k: int,
    *, shared: bool | None = None,
) -> torch.Tensor:
    """(B, W) int32 codes + validity -> (4^k,) int32 histogram of the
    valid codes.  Launches the CUDA kernel for CUDA tensors; CPU tensors
    take the plain twin.

    `shared` picks the kernel's shared-memory histogram (k <= 6) or its
    global-atomic one; None takes shared wherever it fits.  Both give the
    same counts; the choice exists so the two can be held against each
    other on the card."""
    _check(codes, valid, k)
    if shared is None:
        shared = k <= SHARED_MAX_K
    elif shared and k > SHARED_MAX_K:
        raise ValueError(
            f"the shared-memory histogram needs k <= {SHARED_MAX_K}, got {k}"
        )
    dev = codes.device
    if dev.type == "cpu":
        return histogram_reference(codes, valid, k)
    if dev.type != "cuda":
        raise ValueError(f"histogram kernel runs on cuda or cpu, not {dev}")
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
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
    runs in the kernel.  Adds into `table` in place (an int64 table
    takes the int32 delta of one batch, which cannot overflow)."""
    codes, valid = window_ops.window_codes(rows, k, canonical)
    table += histogram_cuda(codes, valid, k)
    return table
