"""C3: the count-of-counts of a flat count array (`histo`'s histogram) as a
hand-written CUDA kernel.

Counterpart of the JAX package's `Spectrum.histo`, a host `np.bincount`
over the pulled spectrum; no Pallas kernel.  `histo`'s recount on one
device bins the finalized store's counts (or a dense table's bins) on the
card with it, so only `max_count + 1` numbers cross to the host
(`KmerCounter.finalize(..., histo_max=)`).  The kernel is
`findkmer_torch/csrc/count_histo.cu`; its design notes are there.  It is
built with nvcc at first use (`_build.py`) and called through ctypes.

`count_histo_cuda` launches the kernel for CUDA tensors into a new
(max_count + 1,) int64 tensor.  For CPU tensors, and only for those, it
runs the plain version `count_histo_reference`.  A build or launch
failure raises; nothing falls back.  `count_histo_cuda.launches` counts
the kernel's launches (never the plain version's); an empty input
launches nothing.

The kernel keeps a block's bins in shared memory where they fit
(`shared_max_count`: ~58 K bins on an H100), else adds into the global
bins.
"""

from __future__ import annotations

import ctypes
import functools

import torch

COUNT_DTYPES = (torch.int32, torch.int64)
MAX_COUNT_LIMIT = (1 << 31) - 2  # bins are indexed by uint32


def count_histo_reference(counts: torch.Tensor,
                          max_count: int) -> torch.Tensor:
    """Plain PyTorch version: h[m] = entries whose count clipped to
    max_count is m, counts <= 0 skipped (so h[0] = 0); (max_count + 1,)
    int64, the input untouched."""
    c = counts.reshape(-1).to(torch.int64)
    c = c[c > 0].clamp_(max=max_count)
    return torch.bincount(c, minlength=max_count + 1)


def _check(counts: torch.Tensor, max_count: int) -> None:
    if counts.dim() != 1:
        raise ValueError(f"counts must be 1-D, got {tuple(counts.shape)}")
    if counts.dtype not in COUNT_DTYPES:
        raise TypeError(f"counts must be int32 or int64, got {counts.dtype}")
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    if not 1 <= max_count <= MAX_COUNT_LIMIT:
        raise ValueError(f"max_count must be in [1, {MAX_COUNT_LIMIT}], "
                         f"got {max_count}")


def _raise(lib, err: int, what: str) -> None:
    msg = lib.fk_cuda_error_string(err).decode()
    raise RuntimeError(f"count-of-counts kernel {what} failed: CUDA error "
                       f"{err} ({msg})")


@functools.cache
def shared_max_count(device_index: int) -> int:
    """The largest max_count whose bins fit one block's shared memory on
    card `device_index`.  Builds the kernels if needed."""
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
    out = ctypes.c_int64()
    with torch.cuda.device(device_index):
        err = lib.fk_count_histo_shared_max(ctypes.byref(out))
    if err:
        _raise(lib, err, "query")
    return out.value


def count_histo_cuda(counts: torch.Tensor, max_count: int) -> torch.Tensor:
    """The count-of-counts of counts (N,) int32/int64: (max_count + 1,)
    int64, h[m] the entries whose count clipped to max_count is m, zero
    counts skipped.  Launches the CUDA kernel for CUDA tensors, with a
    block's bins in shared memory where they fit; CPU tensors take the
    plain version."""
    _check(counts, max_count)
    dev = counts.device
    if dev.type == "cpu":
        return count_histo_reference(counts, max_count)
    if dev.type != "cuda":
        raise ValueError(f"count-of-counts kernel runs on cuda or cpu, "
                         f"not {dev}")
    from findkmer_torch.ops.cuda import _build

    lib = _build.load()
    shared = max_count <= shared_max_count(dev.index)
    with torch.cuda.device(dev):
        out = torch.zeros(max_count + 1, dtype=torch.int64, device=dev)
        if counts.numel() == 0:
            return out
        err = lib.fk_count_histo(
            counts.data_ptr(), counts.numel(), counts.element_size(),
            max_count, out.data_ptr(), int(shared),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        _raise(lib, err, f"launch at {counts.numel()} entries")
    count_histo_cuda.launches += 1
    return out


count_histo_cuda.launches = 0
