"""Device selection for the port.

The JAX package takes `jax.local_devices()[0]` and asks
`jax.default_backend()` which backend it got.  The port instead names its
device explicitly and passes the `torch.device` to everything that
allocates.  A request for CUDA on a machine without it raises: counting
silently on the CPU instead would report CPU numbers as device numbers.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """'cuda' or 'cpu' -> the torch.device to count on.

    Raises RuntimeError for 'cuda' when torch sees no CUDA device, and
    ValueError for any other name.  Never falls back to the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device cuda requested but torch.cuda.is_available() is "
                "False (no CUDA device or a CPU-only torch build); pass "
                "--device cpu to count on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown device {name!r} (expected 'cuda' or 'cpu')")
