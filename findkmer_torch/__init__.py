"""findkmer_torch: the PyTorch / CUDA port of findkmer-tpu.

A second package beside `findkmer_tpu/`, which stays the reference it is
held against.  The port imports `torch` and never `jax`; the JAX-free
host layer of `findkmer_tpu` (config, io, output, the native C encoder)
is reused by import.

What runs today is the dense `count` path (k <= 10 by default; any k up
to 15 with `--table-mode direct`) on one device:

    python -m findkmer_torch.cli count -i in.fa -k 8 -o out.tsv

Its one device kernel, the window-code histogram, is hand-written CUDA
for Hopper (`csrc/histogram.cu`, wrapped by `ops/cuda/histogram_kernel.py`)
and built with nvcc at first use.

Importing the package stays cheap: no torch import here.
"""

from findkmer_tpu.config import Config

__all__ = ["Config"]
