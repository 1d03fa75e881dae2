"""C2: the run-length encoding of the sparse store's sorted rows as a
hand-written CUDA kernel.

Counterpart of the scans of `rle_pos_2d` / `rle_val_2d` in
`findkmer_tpu/ops/sparse.py`, which the JAX package leaves to XLA; no
Pallas kernel.  Every compaction of the store runs one: the device step's,
the finalize's and the cross-row dedup's (`ops/sparse.compact_raw_2d`,
`compact_counted_2d`).  The kernel is `findkmer_torch/csrc/rle.cu`; its
design notes are there.  It is built with nvcc at first use (`_build.py`)
and called through ctypes.

`rle_rows_cuda` launches the kernel for CUDA tensors: in implicit mode
(no counts) into a new tensor of the count dtype, in counted mode IN PLACE
over the counts.  For CPU tensors, and only for those, it runs the plain
version `rle_rows_reference` (the torch chain the kernel replaced) into a
new tensor.  A build or launch failure raises; nothing falls back.
`rle_rows_cuda.launches` counts the kernel's launches (never the plain
version's); `rle_rows_cuda.long_launches` those of them on rows longer
than a tile (`fk_rle_rows_tile`), whose runs the tiles' look-back carries
across tiles: the cross-row dedup, `count --spill`'s dedups.

The tile status words (the look-back's) are the one buffer the kernel
needs besides its output; the wrapper allocates both with `torch.empty`,
so the caching allocator sees them, and the kernel allocates nothing.

`rle_rows` is what `ops/sparse.py` calls: the kernel's wrapper, or the
plain version when asked for it (`plain`, as for `sort_rows`: the
compaction's `KmerCounter(row_sort="plain")`), so the two can be held
against each other on the card.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from findkmer_torch.ops.window import sentinel

KEY_DTYPES = (torch.int32, torch.int64)
COUNT_DTYPES = (torch.int32, torch.int64)


def _adj_flags_2d(codes: torch.Tensor):
    """(is_start, is_end, is_sent) of equal-code runs in sorted rows; a
    row's edges compare against the sentinel, as in the JAX package."""
    sent = sentinel(codes.dtype)
    ne = codes[:, 1:] != codes[:, :-1]
    is_start = torch.cat([codes[:, :1] != sent, ne], dim=1)
    is_end = torch.cat([ne, codes[:, -1:] != sent], dim=1)
    return is_start, is_end, codes == sent


def _run_starts(is_start: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Index of each position's run start (cummax over the start flags:
    positions are monotone, so the propagation is exact)."""
    idx = torch.arange(is_start.shape[1], dtype=dtype,
                       device=is_start.device)
    return torch.cummax(torch.where(is_start, idx, 0), dim=1).values


def rle_rows_reference(codes: torch.Tensor,
                       cnt: Optional[torch.Tensor] = None,
                       count_dtype: torch.dtype = torch.int32
                       ) -> torch.Tensor:
    """Plain PyTorch version, new tensors, inputs untouched.

    Without cnt: run lengths of sorted rows with an implicit count of 1
    per entry, in count_dtype: the run's length at its last position, 0
    elsewhere and at sentinels.  With cnt: the sum of each run's counts
    at its last position, 0 elsewhere and at sentinels, in cnt's dtype.
    The sums are an int64 cumsum differenced at the run starts; int64
    arithmetic wraps modulo 2^64, so a run total is exact whenever it
    fits the count dtype, whatever the row's running sum does (the JAX
    package's `seg_totals` contract)."""
    is_start, is_end, is_sent = _adj_flags_2d(codes)
    if cnt is None:
        spos = _run_starts(is_start, torch.int32)
        idx = torch.arange(codes.shape[1], dtype=torch.int32,
                           device=codes.device)
        run = idx - spos + 1
        run.masked_fill_(~is_end | is_sent, 0)
        return run.to(count_dtype)
    c64 = cnt.to(torch.int64, copy=True)
    cs = torch.cumsum(c64, dim=1)
    excl = c64.neg_().add_(cs)  # cs - cnt, in c64's memory
    before = excl.gather(1, _run_starts(is_start, torch.int64))
    del excl
    cs -= before
    del before
    cs.masked_fill_(~is_end | is_sent, 0)
    return cs.to(cnt.dtype)


def _check(codes: torch.Tensor, cnt: Optional[torch.Tensor],
           count_dtype: torch.dtype) -> None:
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D (R, C), got "
                         f"{tuple(codes.shape)}")
    if codes.dtype not in KEY_DTYPES:
        raise TypeError(f"codes must be int32 or int64, got {codes.dtype}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if cnt is None:
        if count_dtype not in COUNT_DTYPES:
            raise TypeError(f"count_dtype must be int32 or int64, got "
                            f"{count_dtype}")
        return
    if cnt.dtype not in COUNT_DTYPES:
        raise TypeError(f"counts must be int32 or int64, got {cnt.dtype}")
    if cnt.shape != codes.shape:
        raise ValueError(
            f"codes {tuple(codes.shape)} and counts {tuple(cnt.shape)} "
            "differ in shape"
        )
    if cnt.device != codes.device:
        raise ValueError(f"codes on {codes.device} but counts on "
                         f"{cnt.device}")
    if not cnt.is_contiguous():
        raise ValueError("counts must be contiguous")


@functools.cache
def tile() -> int:
    """Slots of one of the kernel's tiles (`fk_rle_rows_tile`).  Builds
    the kernels if needed."""
    from findkmer_torch.ops.cuda import _build

    return _build.load().fk_rle_rows_tile()


def rle_rows_cuda(codes: torch.Tensor, cnt: Optional[torch.Tensor] = None,
                  count_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Run totals of the sorted rows of codes (R, C) int32/int64: each
    run's total at its last slot, 0 elsewhere and at sentinels.

    Without cnt every slot counts 1, into a new (R, C) tensor of
    count_dtype; with cnt (same shape, int32/int64) the counts are summed
    and, for CUDA tensors, the totals written over cnt, which is
    returned.  Launches the CUDA kernel for CUDA tensors; CPU tensors
    take the plain version (a new tensor, cnt untouched)."""
    _check(codes, cnt, count_dtype)
    dev = codes.device
    if dev.type == "cpu":
        return rle_rows_reference(codes, cnt, count_dtype)
    if dev.type != "cuda":
        raise ValueError(f"run-length encoding kernel runs on cuda or cpu, "
                         f"not {dev}")
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
    R, C = codes.shape
    with torch.cuda.device(dev):
        out = (torch.empty(codes.shape, dtype=count_dtype, device=dev)
               if cnt is None else cnt)
        if out.numel() == 0:
            return out
        status = torch.empty(lib.fk_rle_rows_status_words(R * C),
                             dtype=torch.int64, device=dev)
        err = lib.fk_rle_rows(
            codes.data_ptr(), None if cnt is None else cnt.data_ptr(),
            out.data_ptr(), R, C, codes.element_size(), out.element_size(),
            status.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        msg = lib.fk_cuda_error_string(err).decode()
        raise RuntimeError(
            f"run-length encoding kernel launch failed at ({R}, {C}): CUDA "
            f"error {err} ({msg})"
        )
    rle_rows_cuda.launches += 1
    rle_rows_cuda.long_launches += C > tile()
    return out


rle_rows_cuda.launches = 0
rle_rows_cuda.long_launches = 0


def rle_rows(codes: torch.Tensor, cnt: Optional[torch.Tensor] = None,
             count_dtype: torch.dtype = torch.int32,
             plain: bool = False) -> torch.Tensor:
    """The store's run-length encoding: `rle_rows_cuda` (in place over cnt
    on the card), or with plain the plain version (a new tensor).  Use the
    returned tensor."""
    if plain:
        _check(codes, cnt, count_dtype)
        return rle_rows_reference(codes, cnt, count_dtype)
    return rle_rows_cuda(codes, cnt, count_dtype)
