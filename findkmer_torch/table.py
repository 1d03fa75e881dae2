"""The count tables of the port.

Counterpart of `findkmer_tpu/table.py`:
  * DenseTable:  a (4^k,) count vector on the counting device, addressed
    by window code; the dense step adds into it in place.
  * SparseTable: the sparse engine's row store as a checkpointable
    table, (codes, counts) planes of one shape (a code per slot, the
    dtype's max in empty slots, count 0 in empty slots and holes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from findkmer_torch.config import Config

_DTYPES = {"int32": torch.int32, "int64": torch.int64}


def count_dtype(cfg: Config) -> torch.dtype:
    """The torch dtype of cfg.count_dtype."""
    return _DTYPES[cfg.count_dtype]


@dataclass
class DenseTable:
    counts: torch.Tensor  # (4^k,) int32 or int64
    k: int

    @classmethod
    def zeros(cls, cfg: Config, device: torch.device) -> "DenseTable":
        if cfg.k > 15:
            raise ValueError(f"dense table needs k <= 15, got {cfg.k}")
        counts = torch.zeros(4 ** cfg.k, dtype=count_dtype(cfg),
                             device=device)
        return cls(counts=counts, k=cfg.k)

    @classmethod
    def from_host(
        cls, counts: np.ndarray, k: int, device: torch.device
    ) -> "DenseTable":
        """A host (4^k,) count vector, e.g. a JAX counter's dense table
        pulled to numpy, as the port's table on `device`.  Copies, so
        later in-place steps never write into the caller's array."""
        counts = np.asarray(counts)
        if counts.shape != (4 ** k,):
            raise ValueError(
                f"dense table for k={k} needs shape ({4 ** k},), got "
                f"{counts.shape}"
            )
        if counts.dtype not in (np.int32, np.int64):
            raise ValueError(
                f"dense counts must be int32 or int64, got {counts.dtype}"
            )
        return cls(counts=torch.tensor(counts, device=device), k=k)

    def to_host(self) -> np.ndarray:
        """A numpy copy of the counts (waits for the device)."""
        return self.counts.to("cpu", copy=True).numpy()

    def total(self) -> int:
        return int(self.counts.sum())


@dataclass
class SparseTable:
    codes: torch.Tensor   # (G, C) or flat; int32 (k <= 15) or int64
    counts: torch.Tensor  # same shape; 0 in empty slots and holes
    k: int

    def to_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """(codes uint64 sorted ascending distinct, counts int64): the
        live entries, with codes that several rows hold merged."""
        from findkmer_torch.ops.sparse import global_compact

        codes, counts = global_compact(self.codes, self.counts)
        return (codes.cpu().numpy().astype(np.uint64),
                counts.cpu().numpy().astype(np.int64))

    def total(self) -> int:
        return int(self.counts.sum())


def make_table(cfg: Config, device: torch.device) -> DenseTable:
    """Dense-mode table factory."""
    if cfg.resolved_table_mode != "direct":
        raise ValueError(
            f"make_table builds dense tables only (table mode "
            f"{cfg.resolved_table_mode!r})"
        )
    return DenseTable.zeros(cfg, device)
