"""Distributions the particle-filter slice uses."""

from modppl_tpu_torch.dists.base import Distribution
from modppl_tpu_torch.dists.mvnormal import mvnormal
from modppl_tpu_torch.dists.scalar import normal, uniform

__all__ = ["Distribution", "mvnormal", "normal", "uniform"]
