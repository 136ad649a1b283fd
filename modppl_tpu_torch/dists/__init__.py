"""Distributions of the port."""

from modppl_tpu_torch.dists.base import Distribution
from modppl_tpu_torch.dists.iid import iid
from modppl_tpu_torch.dists.mvnormal import mvnormal
from modppl_tpu_torch.dists.scalar import (
    bernoulli,
    categorical,
    normal,
    uniform,
)

__all__ = ["Distribution", "bernoulli", "categorical", "iid", "mvnormal",
           "normal", "uniform"]
