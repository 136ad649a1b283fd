"""The share of the profiled filters' window with no operation on the
device."""

from portbench.readers import idle_pct as read  # noqa: F401
