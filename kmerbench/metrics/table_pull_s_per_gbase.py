"""Seconds a Gbase of input in the program's `finalize/table` spans (the
dense table's pull to the host), their self times summed over the
window.  A job on the sparse store pulls no table and adds 0.  None where
the program does not count its pulls (no `entries_pulled` counter in the
window): a program without the span."""

from kmerbench import program_spans


def read(r):
    w = program_spans.window(r)
    if w is None or not any(c.name == "entries_pulled" for c in w[1]):
        return None
    return sum(s.self_s for s in w[0] if s.name == "finalize/table") \
        / r.gbases
