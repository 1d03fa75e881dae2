"""Per-layer metric readers, found by name: `metrics/<metric>.py` exposes
`read(reading) -> float or None` (None: nothing to read in this cell, and
the metric is left out of the line) and may list `HOOKS`, the kernel
entries whose launches it reads (`spans.install_hooks`).  `reading` is
the harness's `Reading` of one traced window."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"kmerbench.metrics.{name}")
