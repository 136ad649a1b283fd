"""The 95th percentile of a filter's time over every filter of the
traced window, from the CUDA events recorded between filters."""

from portbench.readers import p95_ms as read  # noqa: F401
