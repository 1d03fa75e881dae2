"""Seconds a Gbase of input in the `host_wait` spans (the step loop's wait
for the next staged batch: readers, host batcher, H2D copy), their self
times summed over the window.  The four *_s_per_gbase metrics add up to
about 1 / bases_per_s, less what lies outside every span."""


def read(r):
    return r.per_gbase("host_wait")
