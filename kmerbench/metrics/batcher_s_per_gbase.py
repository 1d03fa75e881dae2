"""Seconds a Gbase of input in the program's `batcher` spans: the
producer thread drawing each batch (reader, encode, pack), not its wait
for room in the queue.  The thread is saturated where this comes near
the window's seconds a Gbase, 1 / `window_bases_per_s`."""

from kmerbench import program_spans


def read(r):
    return program_spans.self_s_per_gbase(r, "batcher")
