"""Seconds a Gbase of input in the program's `write/threshold` spans (each
application of `--min-count` / `--max-count` to a pulled spectrum or
chunk, on the host), their self times summed over the window."""

from kmerbench import program_spans


def read(r):
    return program_spans.self_s_per_gbase(r, "write/threshold")
