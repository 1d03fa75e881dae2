"""Device ops of the port: window extraction, dense histograms, the
sparse store's compactions, and the CUDA kernels' wrappers (`cuda/`).

The exports are the reference's (`findkmer_tpu/ops/__init__.py`) less
what only its TPU layout has: `window_codes_wide` (k > 15 as a (hi, lo)
pair; the port's `window_codes` gives one int64 code for any k <= 31) and
`SENTINEL` (the u32 plane's sentinel; the port's is
`window.sentinel(dtype)`)."""

from findkmer_torch.ops.histogram import dense_counts
from findkmer_torch.ops.sparse import compact_counted, compact_raw
from findkmer_torch.ops.window import window_codes

__all__ = [
    "window_codes",
    "dense_counts",
    "compact_raw",
    "compact_counted",
]
