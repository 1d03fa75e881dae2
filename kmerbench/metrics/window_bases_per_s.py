"""Input bases a second over the traced window: every job's bases over the
wall from the first job's start to the last one's end, as the end-to-end
`bases_per_s` is taken, read here with the profiler and the spans on.  It
stands per layer in the cells whose untraced rate spreads too widely from
run to run to hold a bound."""


def read(r):
    return r.gbases * 1e9 / r.window_s if r.window_s > 0 else None
