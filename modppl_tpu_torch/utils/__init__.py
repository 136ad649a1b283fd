"""Numerics, profiling hooks, diagnostics (``diagnostics``) and
checkpoints (``checkpoint``)."""

from modppl_tpu_torch.utils.numerics import (
    effective_sample_size_from_log_weights,
    logsumexp,
)
from modppl_tpu_torch.utils.profiling import (
    annotate,
    capture_trace,
    compiled_cost,
    device_time,
    hlo_text,
)

__all__ = [
    "logsumexp",
    "effective_sample_size_from_log_weights",
    "annotate", "capture_trace", "device_time", "compiled_cost", "hlo_text",
]
