"""`c1_roofline`, in the cells whose per-layer metrics move
`peak_device_gib`."""

from kmerbench.metrics.c1_roofline import HOOKS, read  # noqa: F401
