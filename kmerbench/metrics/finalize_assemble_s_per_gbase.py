"""Seconds a Gbase of input in the program's `finalize/assemble` spans
(the host copies of the pulled chunks and their concatenation in
`KmerCounter.finalize`, `Spectrum.from_engine`), their self times summed
over the window: the finalize's host assembly, apart from its D2H."""

from kmerbench import program_spans


def read(r):
    return program_spans.self_s_per_gbase(r, "finalize/assemble")
