"""K3: the row sort of the sparse store as a hand-written CUDA kernel.

Counterpart of the Pallas bitonic row sorter of the TPU package
(`bench/probe_plsort.py`, `make_sorter.run` / `sort_kernel`), which is the
row-wise sort of the store's compaction (`findkmer_tpu/ops/compaction.py`).
The kernel is `findkmer_torch/csrc/rowsort.cu`; its design notes are
there.  It is built with nvcc at first use (`_build.py`) and called
through ctypes.

`sort_rows_cuda` sorts each row of a CUDA tensor in place with the
kernel.  For CPU tensors, and only for those, it runs the plain version
`sort_rows_reference` (`torch.sort` along the rows plus a gather of the
payload) and writes its result back in place.  A build or launch failure
raises; nothing falls back.  `sort_rows_cuda.launches` counts the
kernel's launches (never the plain version's), so a run can show that
its compactions went through the kernel.

`sort_rows` is what the compaction calls: the kernel's wrapper, or the
plain version when asked for it (`KmerCounter(row_sort="plain")`, which
exists so the two can be held against each other on the card).

Ties may land in any order, on both paths: every sort of the store is
unstable in the JAX package too, and the run-length encoding that
follows does not depend on the order of equal keys.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

KEY_DTYPES = (torch.int32, torch.int64)
VAL_DTYPES = (torch.int32, torch.int64)


def sort_rows_reference(
    keys: torch.Tensor, vals: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version: new tensors, each row sorted ascending by
    key, vals gathered along."""
    skeys, order = torch.sort(keys, dim=1)
    return skeys, None if vals is None else vals.gather(1, order)


def _check(keys: torch.Tensor, vals: Optional[torch.Tensor]) -> None:
    if keys.dim() != 2:
        raise ValueError(f"keys must be 2-D (G, C), got {tuple(keys.shape)}")
    if keys.dtype not in KEY_DTYPES:
        raise TypeError(f"keys must be int32 or int64, got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if vals is None:
        return
    if vals.dtype not in VAL_DTYPES:
        raise TypeError(f"vals must be int32 or int64, got {vals.dtype}")
    if vals.shape != keys.shape:
        raise ValueError(
            f"keys {tuple(keys.shape)} and vals {tuple(vals.shape)} differ "
            "in shape"
        )
    if vals.device != keys.device:
        raise ValueError(f"keys on {keys.device} but vals on {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("vals must be contiguous")


def sort_rows_cuda(
    keys: torch.Tensor, vals: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort each row of keys (G, C) int32/int64 ascending IN PLACE,
    moving vals (same shape, int32/int64) with their keys; returns
    (keys, vals).  Launches the CUDA kernel for CUDA tensors; CPU
    tensors take the plain version."""
    _check(keys, vals)
    dev = keys.device
    if dev.type == "cpu":
        skeys, svals = sort_rows_reference(keys, vals)
        keys.copy_(skeys)
        if vals is not None:
            vals.copy_(svals)
        return keys, vals
    if dev.type != "cuda":
        raise ValueError(f"row sort kernel runs on cuda or cpu, not {dev}")
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
    G, C = keys.shape
    with torch.cuda.device(dev):
        err = lib.fk_sort_rows(
            keys.data_ptr(), None if vals is None else vals.data_ptr(),
            G, C, keys.element_size(),
            0 if vals is None else vals.element_size(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.fk_cuda_error_string(err).decode()
        raise RuntimeError(
            f"row sort kernel launch failed at ({G}, {C}): CUDA error "
            f"{err} ({msg})"
        )
    sort_rows_cuda.launches += 1
    return keys, vals


sort_rows_cuda.launches = 0


def sort_rows(
    keys: torch.Tensor, vals: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The store's row sort: `sort_rows_cuda` (in place), or with plain
    the plain version (new tensors).  Use the returned tensors."""
    if plain:
        _check(keys, vals)
        return sort_rows_reference(keys, vals)
    return sort_rows_cuda(keys, vals)
