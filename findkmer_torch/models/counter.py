"""KmerCounter of the port: the dense (direct 4^k table) half.

Counterpart of `findkmer_tpu/models/counter.py` with the same counter
interface: `make_counter` -> `init_state` / `step` / `flush` / `finalize`
/ `put_batch` / `table_state` / `restore_state`, so the host layer drives
either engine alike.

One step per batch: `rows_from_batch` -> `window_codes` -> a histogram
added into the table.  PyTorch runs eagerly, so there is no jit; the
table is updated in place where the JAX step donates its buffer.

The histogram is picked from `Config.hist` as in the JAX package:
  * auto:    the CUDA kernel (`ops/cuda/histogram_kernel.py`) when the
             counter's device is CUDA and k <= 10, else scatter.
  * pallas:  the kernel's wrapper (the TPU package's name for its hand
             kernel); on a CPU device the wrapper runs its plain twin.
  * scatter / sort / onehot: the plain ops of `ops/histogram.py`.

Sparse tables (k > Config.direct_k_max, or table_mode="sparse") and
multi-device counting are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from findkmer_tpu.config import Config
from findkmer_torch import table as table_mod
from findkmer_torch.ops import histogram as hist_ops
from findkmer_torch.ops import window as window_ops
from findkmer_torch.ops.cuda.histogram_kernel import MAX_K, add_counts_cuda


def _dense_step(
    table: torch.Tensor,
    batch,
    k: int,
    canonical: bool,
    table_size: int,
    method: str,
    R: int,
) -> torch.Tensor:
    rows = window_ops.rows_from_batch(batch, R)
    codes, valid = window_ops.window_codes(rows, k, canonical)
    return hist_ops.dense_counts(codes, valid, table, table_size, method)


def _kernel_dense_step(
    table: torch.Tensor, batch, k: int, canonical: bool, R: int
) -> torch.Tensor:
    rows = window_ops.rows_from_batch(batch, R)
    return add_counts_cuda(rows, table, k, canonical)


def make_counter(cfg: Config, device: torch.device):
    """The single-device counter for cfg on `device`."""
    from findkmer_tpu.utils.shmalloc import ensure_shared_alloc

    ensure_shared_alloc()  # before this run's big host buffers exist
    if cfg.devices != 1:
        raise NotImplementedError(
            f"--devices {cfg.devices}: multi-device counting is not yet "
            "ported to findkmer_torch (ROADMAP.md Queue 1 item 13)"
        )
    return KmerCounter(cfg, device)


class KmerCounter:
    """Single-device k-mer counter with a dense table."""

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mode = cfg.resolved_table_mode
        if self.mode != "direct":
            raise NotImplementedError(
                f"k={cfg.k} resolves to a sparse table, which is not yet "
                "ported to findkmer_torch (ROADMAP.md Queue 1 item 7, the "
                "sparse slice); k <= 10 counts dense, and "
                "--table-mode direct allows k <= 15"
            )
        if cfg.spill_dir:
            raise ValueError(
                "--spill requires a sparse table "
                f"(k={cfg.k} resolves to a direct table)"
            )
        m = cfg.hist
        if m == "pallas":
            if cfg.k > MAX_K:
                raise ValueError(
                    f"the histogram kernel needs k <= {MAX_K} (got k={cfg.k})"
                )
        elif m == "auto":
            m = (
                "pallas"
                if self.device.type == "cuda" and cfg.k <= MAX_K
                else "scatter"
            )
        self._method = m

    # ------------------------------------------------------------------
    def put_batch(self, batch):
        """Host batch (array or (packed, validbits) pair) -> tensors on
        this counter's device.  The pipeline's prefetch stages batches
        through pinned buffers instead; this is the plain path."""
        if isinstance(batch, (tuple, list)):
            return tuple(self.put_batch(a) for a in batch)
        return torch.from_numpy(batch).to(self.device)

    def init_state(self) -> table_mod.DenseTable:
        return table_mod.make_table(self.cfg, self.device)

    def step(self, state: table_mod.DenseTable, batch) -> table_mod.DenseTable:
        """One batch update, in place on state.counts.

        batch: (B, R) uint8 code rows, or a (packed, validbits) pair in
        the 2-bit H2D format (Config.packed_h2d; unpacked on device)."""
        cfg = self.cfg
        if self._method == "pallas":
            _kernel_dense_step(
                state.counts, batch, cfg.k, cfg.canonical, cfg.row_len
            )
        else:
            _dense_step(
                state.counts, batch, cfg.k, cfg.canonical, cfg.table_size,
                self._method, cfg.row_len,
            )
        return state

    def compact(self, state):
        """Nothing to compact in a dense table."""
        return state

    def flush(self, state):
        return self.compact(state)

    def finalize(self, state, timers=None) -> np.ndarray:
        """The spectrum on the host: np counts (4^k,)."""
        return state.to_host()

    def table_state(self, state):
        """The checkpointable table (the dense state is its own table)."""
        return state, state

    def restore_state(self, table) -> table_mod.DenseTable:
        """Step state from a table: the port's own, or any object with
        `counts` (numpy, a JAX array or a tensor) and `k`, such as a JAX
        DenseTable.  Host counts are copied onto this counter's device."""
        if table.k != self.cfg.k:
            raise ValueError(
                f"table is for k={table.k}, counter for k={self.cfg.k}"
            )
        if isinstance(table.counts, torch.Tensor):
            return table_mod.DenseTable(
                counts=table.counts.to(self.device), k=table.k
            )
        return table_mod.DenseTable.from_host(
            np.asarray(table.counts), table.k, self.device
        )
