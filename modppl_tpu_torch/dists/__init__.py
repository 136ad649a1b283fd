"""Distributions of the port (counterpart of modppl_tpu/dists): the
reference's singletons and classes, the extensions of ``dists/extra.py``,
the ``iid`` and ``plate`` plates and the ``u01`` primitive."""

from modppl_tpu_torch.dists.base import Distribution, Standard, u01
from modppl_tpu_torch.dists.extra import (
    Binomial,
    Dirichlet,
    Exponential,
    Laplace,
    NegativeBinomial,
    StudentT,
    binomial,
    dirichlet,
    exponential,
    laplace,
    negative_binomial,
    student_t,
)
from modppl_tpu_torch.dists.iid import iid
from modppl_tpu_torch.dists.mvnormal import MvNormal, mvnormal
from modppl_tpu_torch.dists.plate import plate
from modppl_tpu_torch.dists.scalar import (
    Bernoulli,
    Beta,
    Categorical,
    Gamma,
    Geometric,
    Normal,
    Poisson,
    UniformContinuous,
    UniformDiscrete,
    bernoulli,
    beta,
    categorical,
    gamma,
    geometric,
    normal,
    poisson,
    uniform,
    uniform_continuous,
    uniform_discrete,
)

__all__ = [
    "Distribution", "Standard", "u01",
    "bernoulli", "uniform_continuous", "uniform", "uniform_discrete",
    "categorical", "normal", "mvnormal", "geometric", "poisson", "gamma",
    "beta",
    "Bernoulli", "UniformContinuous", "UniformDiscrete", "Categorical",
    "Normal", "MvNormal", "Geometric", "Poisson", "Gamma", "Beta",
    "exponential", "laplace", "student_t", "binomial", "dirichlet",
    "negative_binomial",
    "Exponential", "Laplace", "StudentT", "Binomial", "Dirichlet",
    "NegativeBinomial",
    "iid", "plate",
]
