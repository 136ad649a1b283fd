"""Inference diagnostics and numerics."""

from modppl_tpu_torch.utils.numerics import (
    effective_sample_size_from_log_weights,
    logsumexp,
)

__all__ = ["effective_sample_size_from_log_weights", "logsumexp"]
