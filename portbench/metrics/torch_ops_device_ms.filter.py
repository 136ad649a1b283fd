"""Device ms a filter in operations that are not the program's own
kernels: the extend's and the lane keys' PyTorch operations."""

from portbench.readers import torch_ops_ms as read  # noqa: F401
