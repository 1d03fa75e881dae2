"""Plain references, found by name: `reference/<kind>.py` exposes
`streams(inputs, k, canonical, device, variant, **params)`, the byte
streams one job of the program must write, in the order it writes them,
each an iterable of byte pieces.  Plain NumPy and PyTorch; nothing of the
program is imported here."""

from __future__ import annotations

import importlib


def load(kind: str):
    return importlib.import_module(f"kmerbench.reference.{kind}")
