"""Host-side helpers of the port: allocator tuning, the O_DIRECT writer,
phase timers."""
