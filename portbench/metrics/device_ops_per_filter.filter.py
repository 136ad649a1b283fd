"""Device operations (kernels, copies, sets) a filter in the profile."""

from portbench.readers import device_ops_per_unit as read  # noqa: F401
