"""`device_idle_share`, in the cells whose per-layer metrics move
`peak_device_gib`."""

from kmerbench.metrics.device_idle_share import read  # noqa: F401
