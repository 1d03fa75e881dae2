"""Host-side helpers of the port: allocator tuning, the O_DIRECT writer,
phase timers, checkpoints, logging."""

from findkmer_torch.utils.logging import get_logger

__all__ = ["get_logger"]
