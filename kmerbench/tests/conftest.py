"""The benchmark's tests: CPU tests run anywhere; tests marked `cuda` need
a card and skip without one (decided inside the `card` fixture, never at
import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return "cuda"
