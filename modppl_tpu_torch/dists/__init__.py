"""Distributions of the port."""

from modppl_tpu_torch.dists.base import Distribution, Standard
from modppl_tpu_torch.dists.extra import (
    binomial,
    dirichlet,
    exponential,
    laplace,
    negative_binomial,
    student_t,
)
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

__all__ = ["Distribution", "Standard", "bernoulli", "beta", "binomial",
           "categorical", "dirichlet", "exponential", "gamma", "geometric",
           "iid", "laplace", "mvnormal", "negative_binomial", "normal",
           "plate", "poisson", "student_t", "uniform", "uniform_discrete"]
