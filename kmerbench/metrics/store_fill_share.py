"""How full the sparse row store was at each finalize: 100 x the
program's counter `store_live` (live entries) over `store_slots` (rows x
columns), summed over the window.  The rest are holes, device memory
that holds nothing."""

from kmerbench import program_spans


def read(r):
    return program_spans.share(r, "store_live", "store_slots")
