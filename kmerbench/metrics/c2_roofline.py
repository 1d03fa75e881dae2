"""C2 (`findkmer_torch/csrc/rle.cu`, the store's run-length encoding): its
share of its roofline.  Bytes a launch, as `chip_smoke.py`'s
`phase_rle_timing` counts them: the keys read once, the counts read once
in counted mode, the totals written once.

A program without C2 has no wrapper to hook: then no hook is installed
(`spans.install_hooks` imports each hook's module), and the metric reads
nothing and is left out of the line."""

import importlib.util
import re

from kmerbench import roofline

_MODULE = "findkmer_torch.ops.cuda.rle_kernel"


def _bytes(a, kw, out):
    codes = a[0]
    cnt = a[1] if len(a) > 1 else kw.get("cnt")
    return codes.nbytes + (0 if cnt is None else cnt.nbytes) + out.nbytes


HOOKS = ([("c2", _MODULE, "rle_rows_cuda", "rle_rows_cuda", _bytes)]
         if importlib.util.find_spec(_MODULE) is not None else [])
KERNEL = re.compile(r"(^|[\s:])rle_rows\s*[(<]")


def read(r):
    return roofline.share(r, {"c2"}, KERNEL)
