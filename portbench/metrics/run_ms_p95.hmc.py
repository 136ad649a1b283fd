"""The 95th percentile of a run's time over every run of the traced
window, from the CUDA events recorded between runs."""

from portbench.readers import p95_ms as read  # noqa: F401
