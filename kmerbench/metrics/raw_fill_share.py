"""How full the sparse store's raw buffer was when it was sorted: 100 x
the program's counter `raw_slots_filled` (the fill at each compaction)
over `raw_slots_sorted` (the raw capacity each compaction sorts), summed
over the window.  A low share is device memory sized and sorted for
nothing."""

from kmerbench import program_spans


def read(r):
    return program_spans.share(r, "raw_slots_filled", "raw_slots_sorted")
