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
its compactions went through the kernel; `sort_rows_cuda.long_launches`
counts those of them on rows longer than a tile (the merge sort: the
cross-row dedup, a raised --sparse-capacity).

Rows longer than a tile are a merge sort: spans sorted in place inside
shared memory, then merge-path passes that ping-pong between the rows
and a scratch of their shape.  The geometry lives in the kernel's source
alone: `sort_plan` asks the library how many passes a shape takes and
how many splits they need, and the wrapper allocates the scratch and the
splits with `torch.empty`, so the caching allocator sees them; the
kernel allocates nothing.

`sort_rows` is what the compaction calls: the kernel's wrapper, or the
plain version when asked for it (`KmerCounter(row_sort="plain")`, which
exists so the two can be held against each other on the card).

Ties may land in any order, on both paths: every sort of the store is
unstable in the JAX package too, and the run-length encoding that
follows does not depend on the order of equal keys.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

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


class SortPlan(NamedTuple):
    """What the kernel does with a shape (`fk_sort_rows_scratch`):
    long_row when the rows are longer than a tile (the merge sort),
    passes its merge passes, parts the int64 splits they need."""

    long_row: bool
    passes: int
    parts: int


def sort_plan(G: int, C: int, key_bytes: int, val_bytes: int) -> SortPlan:
    """The library's plan for G rows of C slots of key_bytes keys and
    val_bytes payloads (0: none).  Builds the kernels if needed."""
    from findkmer_torch.ops.cuda import _build

    long_row, passes, parts = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
    if _build.load().fk_sort_rows_scratch(
            G, C, key_bytes, val_bytes, ctypes.byref(long_row),
            ctypes.byref(passes), ctypes.byref(parts)):
        raise ValueError(f"no row sort of ({G}, {C}) with {key_bytes}-byte "
                         f"keys and {val_bytes}-byte payloads")
    return SortPlan(bool(long_row.value), passes.value, parts.value)


def _scratch(keys: torch.Tensor, vals: Optional[torch.Tensor],
             plan: SortPlan) -> tuple:
    """The merge passes' buffers: scratch keys and vals of the rows'
    shape and the splits; all None for rows that take no merge pass."""
    if not plan.passes:
        return None, None, None
    return (torch.empty_like(keys),
            None if vals is None else torch.empty_like(vals),
            torch.empty(plan.parts, dtype=torch.int64, device=keys.device))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
    sizes = keys.element_size(), 0 if vals is None else vals.element_size()
    plan = sort_plan(G, C, *sizes)
    with torch.cuda.device(dev):
        scratch = _scratch(keys, vals, plan)
        err = lib.fk_sort_rows(
            _ptr(keys), _ptr(vals), *map(_ptr, scratch), G, C, *sizes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.fk_cuda_error_string(err).decode()
        raise RuntimeError(
            f"row sort kernel launch failed at ({G}, {C}): CUDA error "
            f"{err} ({msg})"
        )
    sort_rows_cuda.launches += 1
    sort_rows_cuda.long_launches += plan.long_row
    return keys, vals


sort_rows_cuda.launches = 0
sort_rows_cuda.long_launches = 0


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
