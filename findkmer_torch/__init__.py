"""findkmer_torch: the PyTorch / CUDA port of findkmer-tpu.

A second package beside `findkmer_tpu/`, which stays the reference it is
held against.  The port imports `torch`, never `jax`, and nothing of
`findkmer_tpu`: it keeps its own copy of the host layer it needs
(`config`, `io`, `output`, `utils`, the loader of the C host encoder,
which compiles `_native/encode.c`, the package's copy of the
repository's `src/native/encode.c`, into the port's own build cache,
`_native.cache_dir`).  Only the tests import both packages, to hold each
copy to its original.

What runs today on one device, for any k up to 31 (a dense 4^k table for
k <= 10, k <= 15 with `--table-mode direct`; the sparse sorted-run store
above): `count` (one combined spectrum, `--per-input`, `--per-record`),
`stream` (the restartable count: `--checkpoint`, exact resume), the disk
spill of both (`--spill`), `filter` (read filtering by spectrum
membership, single-end and paired, by the host C scan or on the device),
`selftest`, the spectrum tools (`merge`, `matrix`, `expr`,
`intersect`, `subtract`, `sort`, `canonize`, `query`, `topn`, `histo`,
`info`, `similarity`, `sketch`, `diff`, `stats`; `matrix -k`, `sketch -k`
and `histo` count on the device first), and the library API `count` /
`count_per_record` / `count_text` / `sketch_sample` / `filter_reads` /
`matrix` / `expr` / `similarity` / `stream_count` (`api.py`):

    python -m findkmer_torch.cli count -i in.fa -k 21 --canonical -o out.tsv
    python -m findkmer_torch.cli stream -i in.fa -k 21 -o out.tsv --checkpoint ck
    python -m findkmer_torch.cli filter -i reads.fq --spectrum spec.tsv -o kept.fq
    python -m findkmer_torch.cli selftest --device cuda

Its device kernels are hand-written CUDA for Hopper, built with nvcc at
first use: the window-code histogram K1 (`csrc/histogram.cu`, wrapped by
`ops/cuda/histogram_kernel.py`), the fused window histogram K2 of the
dense step (`csrc/window_histogram.cu`,
`ops/cuda/window_histogram_kernel.py`), the sparse path's window
extraction C1 (`csrc/window_codes.cu`, `ops/cuda/window_codes_kernel.py`),
the store's row sort K3 (`csrc/rowsort.cu`, `ops/cuda/rowsort_kernel.py`),
its run-length encoding C2 (`csrc/rle.cu`, `ops/cuda/rle_kernel.py`) and
`histo`'s count-of-counts C3 (`csrc/count_histo.cu`,
`ops/cuda/count_histo_kernel.py`).  The sources ship in
the package, so an installed tree builds them too.

Importing the package stays cheap: no torch import here.
"""

from findkmer_torch.version import __version__
from findkmer_torch.config import Config


def __getattr__(name):
    # lazy: the API imports torch
    # NOTE: no lazy export may share a name with a submodule (e.g.
    # "sketch"): once the submodule is imported it becomes the package
    # attribute and would shadow the function; hence sketch_sample
    if name in ("count", "count_per_record", "count_text", "filter_reads",
                "stream_count", "Spectrum", "sketch_sample", "similarity",
                "matrix", "expr"):
        from findkmer_torch import api

        return getattr(api, name)
    raise AttributeError(name)


__all__ = ["Config", "count", "count_per_record", "count_text",
           "filter_reads", "stream_count", "Spectrum", "sketch_sample",
           "similarity", "matrix", "expr", "__version__"]
