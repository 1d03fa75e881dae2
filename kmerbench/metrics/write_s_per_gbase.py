"""Seconds a Gbase of input in the `write` spans (formatting and writing
the spectrum, or the histogram and its lines), their self times summed
over the window.  The four *_s_per_gbase metrics add up to about
1 / bases_per_s, less what lies outside every span."""


def read(r):
    return r.per_gbase("write")
