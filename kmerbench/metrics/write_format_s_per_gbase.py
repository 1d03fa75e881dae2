"""Seconds a Gbase of input in the program's `write/format` spans (each
chunk's formatting, the C formatter where it builds), their self times
summed over the window: the formatter's part of `write`."""

from kmerbench import program_spans


def read(r):
    return program_spans.self_s_per_gbase(r, "write/format")
