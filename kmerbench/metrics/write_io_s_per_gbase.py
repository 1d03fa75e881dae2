"""Seconds a Gbase of input in the program's `write/io` spans (each
write of formatted bytes into the output), their self times summed over
the window: the writes' part of `write`, beside `write_format`."""

from kmerbench import program_spans


def read(r):
    return program_spans.self_s_per_gbase(r, "write/io")
