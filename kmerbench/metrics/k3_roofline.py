"""K3 (`findkmer_torch/csrc/rowsort.cu`, the store's row sort): its share
of its roofline.  Bytes a launch, as `chip_smoke.py`'s
`phase_rowsort_timing` counts them: keys and payload read once and
written once."""

import re

from kmerbench import roofline


def _bytes(a, kw, out):
    keys = a[0]
    vals = a[1] if len(a) > 1 else kw.get("vals")
    slot = keys.element_size() + (0 if vals is None else vals.element_size())
    return 2 * keys.numel() * slot


HOOKS = [("k3", "findkmer_torch.ops.cuda.rowsort_kernel", "sort_rows_cuda",
          "sort_rows_cuda", _bytes)]
KERNEL = re.compile(
    r"(^|[\s:])(sort_small|sort_tiles|sort_spans|merge_partition|merge_pass)"
    r"\s*[(<]")


def read(r):
    return roofline.share(r, {"k3"}, KERNEL)
