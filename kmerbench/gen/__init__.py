"""Traffic generators, found by name: `gen/<generator>.py` exposes
`generate(out_dir, seed, params) -> {"inputs": [paths], "bases": int}`,
`bases` every sequence letter written (N and lowercase included), the
count the benchmark's rates divide by.  The same seed and parameters give
the same bytes."""

from __future__ import annotations

import importlib

from kmerbench.gen import common  # noqa: F401  (`common.release`)


def load(name: str):
    return importlib.import_module(f"kmerbench.gen.{name}")
