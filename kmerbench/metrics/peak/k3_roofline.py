"""`k3_roofline`, in the cells whose per-layer metrics move
`peak_device_gib`."""

from kmerbench.metrics.k3_roofline import HOOKS, read  # noqa: F401
