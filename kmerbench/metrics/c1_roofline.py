"""C1 (`findkmer_torch/csrc/window_codes.cu`, the sparse ingest's window
extraction): its share of its roofline.  Bytes a launch, as
`chip_smoke.py`'s `phase_window_codes_timing` counts them: the 2-bit
wire (packed and validbits) read once, the codes written once."""

import re

from kmerbench import roofline

HOOKS = [("c1", "findkmer_torch.ops.cuda.window_codes_kernel",
          "window_codes_packed_cuda", "window_codes_packed_cuda",
          lambda a, kw, out: a[0].nbytes + a[1].nbytes + out.nbytes)]
KERNEL = re.compile(r"(^|[\s:])window_codes\s*[(<]")


def read(r):
    return roofline.share(r, {"c1"}, KERNEL)
