"""`finalize_assemble_s_per_gbase`, in the cells whose per-layer metrics
move `peak_device_gib`."""

from kmerbench.metrics.finalize_assemble_s_per_gbase import read  # noqa: F401
