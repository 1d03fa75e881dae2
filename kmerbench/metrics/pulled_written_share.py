"""How much of what the finalize pulled to the host was written: 100 x
the program's counter `entries_written` (spectrum lines formatted) over
`entries_pulled` (spectrum entries that crossed to the host: the sparse
finalize's chunks, or the dense table's 4^k bins), summed over the
window.  The rest was pulled only to be dropped by a threshold, or is
the dense table's empty bins."""

from kmerbench import program_spans


def read(r):
    return program_spans.share(r, "entries_written", "entries_pulled")
