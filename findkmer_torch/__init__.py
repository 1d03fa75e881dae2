"""findkmer_torch: the PyTorch / CUDA port of findkmer-tpu.

A second package beside `findkmer_tpu/`, which stays the reference it is
held against.  The port imports `torch` and never `jax`; the JAX-free
host layer of `findkmer_tpu` (config, io, output, the native C encoder)
is reused by import.

What runs today is `count` on one device, for any k up to 31: a dense
4^k table for k <= 10 (k <= 15 with `--table-mode direct`), the sparse
sorted-run store above:

    python -m findkmer_torch.cli count -i in.fa -k 21 --canonical -o out.tsv

Its device kernels are hand-written CUDA for Hopper, built with nvcc at
first use: the window-code histogram K1 (`csrc/histogram.cu`, wrapped by
`ops/cuda/histogram_kernel.py`) and the store's row sort K3
(`csrc/rowsort.cu`, `ops/cuda/rowsort_kernel.py`).

Importing the package stays cheap: no torch import here.
"""

from findkmer_tpu.config import Config

__all__ = ["Config"]
