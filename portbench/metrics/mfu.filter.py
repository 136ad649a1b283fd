"""The whole filter's least time at the peaks (the larger of its
bytes and operations from N and T) over its measured time."""

from portbench.readers import mfu_pct as read  # noqa: F401
