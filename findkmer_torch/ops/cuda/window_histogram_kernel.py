"""K2: the fused window histogram as a hand-written CUDA kernel.

Counterpart of `fused_window_histogram` in
`findkmer_tpu/ops/pallas/histogram_kernel.py`: rows of bases in, the
(4^k,) int32 histogram of all their valid windows out, k <= 10, with the
window extraction inside the kernel.  The kernel is
`findkmer_torch/csrc/window_histogram.cu`; its design notes are there.
It is built with nvcc at first use (`_build.py`) and called through
ctypes.  Two entries share its one device body:

  * `fused_window_histogram_cuda(rows, k, canonical)`: (B, R) uint8 rows,
    the JAX function's own contract.
  * `fused_window_histogram_packed_cuda(packed, validbits, k, canonical,
    R)`: the 2-bit wire the pipeline stages (`ops/window.unpack_rows`).

Both launch the kernel for CUDA tensors.  For CPU tensors, and only for
those, they run the plain PyTorch version (`window_codes`, after
`unpack_rows` for the wire, then `bincount`): the port's counterpart of
the Pallas kernel's `interpret=True`.  A build or launch failure raises;
nothing falls back.

`fused_window_histogram_cuda.launches` counts the kernel's launches from
either entry (never the plain version's), so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import torch

from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda.histogram_kernel import (
    MAX_K,
    SHARED_MAX_K,
    check_out,
    private_bins,
)


def fused_window_histogram_reference(
    rows: torch.Tensor, k: int, canonical: bool = False
) -> torch.Tensor:
    """Plain PyTorch version: (4^k,) int32 histogram of the valid windows
    of (B, R) uint8 rows, on the rows' device."""
    if rows.shape[-1] < k:
        return torch.zeros(4 ** k, dtype=torch.int32, device=rows.device)
    codes, valid = window_ops.window_codes(rows, k, canonical)
    return torch.bincount(codes[valid], minlength=4 ** k).to(torch.int32)


def fused_window_histogram_packed_reference(
    packed: torch.Tensor, validbits: torch.Tensor, k: int,
    canonical: bool, R: int,
) -> torch.Tensor:
    """Plain PyTorch version of the wire entry: unpack, then as above."""
    return fused_window_histogram_reference(
        window_ops.unpack_rows(packed, validbits, R), k, canonical)


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"the fused window histogram needs 1 <= k <= {MAX_K}, got {k}"
        )


def _check_bytes(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(
            "inputs on different devices: "
            + ", ".join(str(t.device) for t in tensors)
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(
            f"the fused window histogram runs on cuda or cpu, not {dev}"
        )
    return dev


def _private(private: bool | None, k: int, windows: int) -> bool:
    if private is None:
        return private_bins(k, windows)
    if private and k > SHARED_MAX_K:
        raise ValueError(
            f"block-private bins need k <= {SHARED_MAX_K}, got {k}"
        )
    return private


def _launch(entry: str, dev: torch.device, k: int, canonical: bool,
            private: bool, out: torch.Tensor | None, *args) -> torch.Tensor:
    """Call the library's `entry` with its leading `args`; it adds into
    `out`, or into a fresh zeroed histogram."""
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
    if out is None:
        out = torch.zeros(4 ** k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *args, out.data_ptr(), k, int(canonical), int(private),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.fk_cuda_error_string(err).decode()
        raise RuntimeError(
            f"fused window histogram launch failed: CUDA error {err} ({msg})"
        )
    fused_window_histogram_cuda.launches += 1
    return out


def _no_launch(hist: torch.Tensor | None, k: int, dev: torch.device,
               out: torch.Tensor | None) -> torch.Tensor:
    """The result where no kernel runs: `hist` (None: zeros) fresh, or
    added into `out`."""
    if out is None:
        return (torch.zeros(4 ** k, dtype=torch.int32, device=dev)
                if hist is None else hist)
    return out if hist is None else out.add_(hist)


def fused_window_histogram_cuda(
    rows: torch.Tensor, k: int, canonical: bool = False,
    *, private: bool | None = None, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, R) uint8 rows -> (4^k,) int32 histogram of their valid windows.
    Launches the kernel for CUDA tensors; CPU tensors take the plain
    version.  Rows too short for one window give zeros, with no launch.

    `private` picks the kernel's block-private shared-memory bins
    (k <= 9) or its atomics on the global table; None takes
    `private_bins(k, windows)`.  Both give the same counts.  `out`, an
    int32 (4^k,) tensor on the rows' device, is added to in place and
    returned, instead of a fresh histogram."""
    _check_k(k)
    _check_bytes("rows", rows)
    dev = _device(rows)
    B, R = rows.shape
    private = _private(private, k, B * max(R - k + 1, 0))
    if out is not None:
        check_out(out, k, dev)
    if dev.type == "cpu":
        return _no_launch(fused_window_histogram_reference(rows, k, canonical),
                          k, dev, out)
    if B == 0 or R < k:
        return _no_launch(None, k, dev, out)
    return _launch("fk_window_histogram", dev, k, canonical, private, out,
                   rows.data_ptr(), B, R)


fused_window_histogram_cuda.launches = 0


def fused_window_histogram_packed_cuda(
    packed: torch.Tensor, validbits: torch.Tensor, k: int,
    canonical: bool, R: int,
    *, private: bool | None = None, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """The 2-bit wire -> (4^k,) int32 histogram of the valid windows.

    packed (B, R8/4) and validbits (B, R8/8) uint8, MSB first, as
    `ops/window.unpack_rows` takes them; R <= R8 is the true row length:
    no window reaches a slot at or past it.  Launches the kernel for CUDA
    tensors (counted on `fused_window_histogram_cuda.launches`); CPU
    tensors take the plain version.  `private` and `out` as for the rows
    entry."""
    _check_k(k)
    _check_bytes("packed", packed)
    _check_bytes("validbits", validbits)
    dev = _device(packed, validbits)
    B, nbp = packed.shape
    nbv = validbits.shape[1]
    if validbits.shape[0] != B or nbp != 2 * nbv:
        raise ValueError(
            f"packed {tuple(packed.shape)} and validbits "
            f"{tuple(validbits.shape)} are not one (B, R8/4), (B, R8/8) wire"
        )
    if not 0 <= R <= 4 * nbp:
        raise ValueError(f"R={R} outside the wire's 0..{4 * nbp} bases")
    private = _private(private, k, B * max(R - k + 1, 0))
    if out is not None:
        check_out(out, k, dev)
    if dev.type == "cpu":
        return _no_launch(fused_window_histogram_packed_reference(
            packed, validbits, k, canonical, R), k, dev, out)
    if B == 0 or R < k:
        return _no_launch(None, k, dev, out)
    return _launch("fk_window_histogram_packed", dev, k, canonical, private,
                   out, packed.data_ptr(), validbits.data_ptr(), B, nbp, nbv,
                   R)


def add_window_counts_cuda(
    batch, table: torch.Tensor, k: int, canonical: bool, R: int
) -> torch.Tensor:
    """table += histogram of all valid windows of one batch, through K2:
    the wire entry for a (packed, validbits) pair, the rows entry for
    (B, R) uint8 rows.  The kernel adds into an int32 `table` itself; an
    int64 table takes the int32 delta of one batch, which cannot
    overflow."""
    out = (table if table.dtype == torch.int32 and table.is_contiguous()
           else None)
    if isinstance(batch, (tuple, list)):
        packed, validbits = batch
        delta = fused_window_histogram_packed_cuda(
            packed, validbits, k, canonical, R, out=out)
    else:
        delta = fused_window_histogram_cuda(batch, k, canonical, out=out)
    if out is None:
        table += delta
    return table
