"""Inference: importance sampling, Metropolis-Hastings and the eager
particle filter over any GenFn; the batched filters (``vsmc``), HMC
(``hmc``) and the batched MCMC kernels (``mcmc``) are modules of their
own."""

from modppl_tpu_torch.inference.importance import (
    importance_resampling,
    importance_sampling,
    tree_index,
)
from modppl_tpu_torch.inference.mh import (
    metropolis_hastings,
    mh,
    regen_mh,
    regenerative_metropolis_hastings,
)
from modppl_tpu_torch.inference.smc import ParticleSystem

__all__ = ["ParticleSystem", "importance_resampling", "importance_sampling",
           "metropolis_hastings", "mh", "regen_mh",
           "regenerative_metropolis_hastings", "tree_index"]
