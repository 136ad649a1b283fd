"""Distributions of the port."""

from modppl_tpu_torch.dists.base import Distribution, Standard
from modppl_tpu_torch.dists.iid import iid
from modppl_tpu_torch.dists.mvnormal import mvnormal
from modppl_tpu_torch.dists.plate import plate
from modppl_tpu_torch.dists.scalar import (
    bernoulli,
    beta,
    categorical,
    gamma,
    geometric,
    normal,
    poisson,
    uniform,
    uniform_discrete,
)

__all__ = ["Distribution", "Standard", "bernoulli", "beta", "categorical",
           "gamma", "geometric", "iid", "mvnormal", "normal", "plate",
           "poisson", "uniform", "uniform_discrete"]
