"""Dense count-table accumulation in plain PyTorch (4^k table, k <= 15).

Counterpart of `findkmer_tpu/ops/histogram.py`; these back
`--hist scatter|sort|onehot` as they do in the JAX package:

  * scatter - one `index_add_` of ones over the whole batch.
  * sort    - sort the batch's codes, run-length-encode, add the runs.
    Deterministic; the cross-check for every other path.
  * onehot  - compare each code against every bin and sum the matches.
    N * 4^k work: only sensible for small k.

All three send invalid windows to a trash bin at index 4^k, which is
dropped before the table is updated.  Each adds into `table` in place
and returns it.  The hand-written CUDA histogram (`--hist pallas`, the
counterpart of the TPU's Pallas kernel) is in `ops/cuda/`.
"""

from __future__ import annotations

import torch


def _flat_codes(codes: torch.Tensor, valid: torch.Tensor, table_size: int):
    """Flatten (B, W) codes, sending invalid windows to the trash bin."""
    return torch.where(valid, codes, table_size).reshape(-1)


def _with_trash(table: torch.Tensor) -> torch.Tensor:
    return torch.zeros(
        table.shape[0] + 1, dtype=table.dtype, device=table.device
    )


def add_counts_scatter(
    codes: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
    table_size: int,
) -> torch.Tensor:
    """table (4^k,) += histogram(codes[valid]) via index_add_."""
    idx = _flat_codes(codes, valid, table_size)
    delta = _with_trash(table)
    ones = torch.ones((), dtype=table.dtype, device=table.device)
    delta.index_add_(0, idx, ones.expand(idx.numel()))
    table += delta[:table_size]
    return table


def add_counts_sort(
    codes: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
    table_size: int,
) -> torch.Tensor:
    """table += histogram via sort + run-length + sparse add."""
    idx = torch.sort(_flat_codes(codes, valid, table_size)).values
    run_code, run_len = torch.unique_consecutive(idx, return_counts=True)
    delta = _with_trash(table)
    delta.index_add_(0, run_code, run_len.to(table.dtype))
    table += delta[:table_size]
    return table


def add_counts_onehot(
    codes: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
    table_size: int, chunk: int = 512,
) -> torch.Tensor:
    """table += histogram via one-hot tiles reduced over the windows.

    At most `chunk` windows per (windows, 4^k) bool tile, fewer when the
    table is large, so one tile stays near 16 M entries.  The trash code
    4^k matches no bin and drops out."""
    idx = _flat_codes(codes, valid, table_size)
    bins = torch.arange(table_size, dtype=idx.dtype, device=idx.device)
    rows = max(1, min(chunk, (1 << 24) // table_size))
    for tile in idx.split(rows):
        table += (tile[:, None] == bins).sum(0, dtype=table.dtype)
    return table


_DENSE_FNS = {
    "scatter": add_counts_scatter,
    "sort": add_counts_sort,
    "onehot": add_counts_onehot,
}


def dense_counts(
    codes: torch.Tensor,
    valid: torch.Tensor,
    table: torch.Tensor,
    table_size: int,
    method: str = "scatter",
) -> torch.Tensor:
    """Dispatch to a plain dense accumulation method by name."""
    if method not in _DENSE_FNS:
        raise ValueError(
            f"dense_counts runs {sorted(_DENSE_FNS)}, not {method!r}; "
            "hist=auto|pallas (the CUDA kernel) is picked in "
            "models/counter.py"
        )
    return _DENSE_FNS[method](codes, valid, table, table_size)


def histogram(codes: torch.Tensor, valid: torch.Tensor, table_size: int):
    """Fresh int32 histogram (no accumulation); convenience for tests."""
    table = torch.zeros(table_size, dtype=torch.int32, device=codes.device)
    return add_counts_scatter(codes, valid, table, table_size)
