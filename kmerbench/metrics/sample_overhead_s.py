"""The median over the window's samples of a sample's wall (from the
previous sample's output closing, or the call's start, to its own output
closing) less the self times of its host_wait, dispatch, finalize and
write spans: the per-input loop's fixed cost a sample (counter creation,
sizing, the output's open)."""

import statistics


def read(r):
    over = [wall - spans for wall, spans in r.samples]
    return statistics.median(over) if over else None
