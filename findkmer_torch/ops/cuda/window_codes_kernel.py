"""C1: the sparse path's window extraction as a hand-written CUDA kernel.

Counterpart of `window_codes_packed` in `findkmer_tpu/ops/window.py`,
which the JAX package leaves to XLA (fused into its sparse ingest under
`jax.jit`).  The 2-bit wire of a batch in, one flat tensor of window codes
out, in the plain version's residue-interleaved slot order
(`ops/window.window_codes_packed`): the sparse store does not depend on
that order, the device filter's hit bitmap does.  The kernel is
`findkmer_torch/csrc/window_codes.cu`; its design notes are there.  It is
built with nvcc at first use (`_build.py`) and called through ctypes.

`window_codes_packed_cuda` launches the kernel for CUDA tensors.  For CPU
tensors, and only for those, it runs the plain version
`ops/window.window_codes_packed`.  A build or launch failure raises;
nothing falls back.  `window_codes_packed_cuda.launches` counts the
kernel's launches (never the plain version's), so a run can show that its
ingests went through the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda.window_histogram_kernel import _check_bytes


def window_codes_packed_cuda(
    packed: torch.Tensor, validbits: torch.Tensor, k: int,
    canonical: bool = False, R: int = 0,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`ops/window.window_codes_packed` through the kernel: the same slots
    in the same order, invalid slots the sentinel.

    packed (B, R8/4) and validbits (B, R8/8) uint8, MSB first, as the host
    packer lays them out; R, the true row length, trims the word streams
    (`packed_slots`; 0 takes every word).  `out`, when given, is filled in
    place: a contiguous (packed_slots,) tensor of `code_dtype(k)` on the
    wire's device.  Launches the kernel for CUDA tensors; CPU tensors take
    the plain version."""
    if not 1 <= k <= window_ops.MAX_K:
        raise ValueError(
            f"window_codes_packed needs 1 <= k <= {window_ops.MAX_K}, got {k}"
        )
    _check_bytes("packed", packed)
    _check_bytes("validbits", validbits)
    dev = packed.device
    if validbits.device != dev:
        raise ValueError(f"inputs on different devices: {dev}, "
                         f"{validbits.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the window extraction runs on cuda or cpu, not "
                         f"{dev}")
    B, nbp = packed.shape
    nbv = validbits.shape[1]
    if validbits.shape[0] != B or nbp != 2 * nbv:
        raise ValueError(
            f"packed {tuple(packed.shape)} and validbits "
            f"{tuple(validbits.shape)} are not one (B, R8/4), (B, R8/8) wire"
        )
    dt = window_ops.code_dtype(k)
    n = window_ops.packed_slots(B, nbp, k, R)
    if out is None:
        out = torch.empty(n, dtype=dt, device=dev)
    elif out.shape != (n,) or out.dtype != dt:
        raise ValueError(
            f"out must be ({n},) {dt}, got {tuple(out.shape)} {out.dtype}"
        )
    elif out.device != dev or not out.is_contiguous():
        raise ValueError(f"out must be contiguous on {dev}, got "
                         f"{out.device}, strides {out.stride()}")
    if dev.type == "cpu":
        return window_ops.window_codes_packed(packed, validbits, k, canonical,
                                              R=R, out=out)
    if n == 0:
        return out
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.fk_window_codes_packed(
            packed.data_ptr(), validbits.data_ptr(), B, nbp, nbv,
            n // (16 * B), out.data_ptr(), k, int(canonical),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.fk_cuda_error_string(err).decode()
        raise RuntimeError(
            f"window extraction launch failed: CUDA error {err} ({msg})"
        )
    window_codes_packed_cuda.launches += 1
    return out


window_codes_packed_cuda.launches = 0
