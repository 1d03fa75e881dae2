"""K2 (`findkmer_torch/csrc/window_histogram.cu`, the dense step): its
share of its roofline.  Bytes a launch, as `chip_smoke.py`'s window
kernel timing counts them: the wire (or the uint8 rows) read once, the
4^k int32 table written once."""

import re

from kmerbench import roofline

_MOD = "findkmer_torch.ops.cuda.window_histogram_kernel"


def _packed(a, kw, out):
    return a[0].nbytes + a[1].nbytes + 4 * 4 ** a[2]


def _rows(a, kw, out):
    return a[0].nbytes + 4 * 4 ** a[1]


HOOKS = [("k2", _MOD, "fused_window_histogram_packed_cuda",
          "fused_window_histogram_cuda", _packed),
         ("k2", _MOD, "fused_window_histogram_cuda",
          "fused_window_histogram_cuda", _rows)]
KERNEL = re.compile(r"(^|[\s:])window_hist\s*[(<]")


def read(r):
    return roofline.share(r, {"k2"}, KERNEL)
