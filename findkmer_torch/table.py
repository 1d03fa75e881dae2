"""The dense count table of the port.

Counterpart of `findkmer_tpu/table.py` (`DenseTable`, `make_table`): a
(4^k,) count vector on the counting device, addressed by window code.
The step functions of `models/counter.py` add into it in place.
`SparseTable` is ported with the sparse slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from findkmer_tpu.config import Config

_DTYPES = {"int32": torch.int32, "int64": torch.int64}


@dataclass
class DenseTable:
    counts: torch.Tensor  # (4^k,) int32 or int64
    k: int

    @classmethod
    def zeros(cls, cfg: Config, device: torch.device) -> "DenseTable":
        if cfg.k > 15:
            raise ValueError(f"dense table needs k <= 15, got {cfg.k}")
        counts = torch.zeros(
            4 ** cfg.k, dtype=_DTYPES[cfg.count_dtype], device=device
        )
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


def make_table(cfg: Config, device: torch.device) -> DenseTable:
    """Dense-mode table factory."""
    if cfg.resolved_table_mode != "direct":
        raise ValueError(
            f"make_table builds dense tables only (table mode "
            f"{cfg.resolved_table_mode!r})"
        )
    return DenseTable.zeros(cfg, device)
