"""Inference: importance sampling, Metropolis-Hastings, the eager particle
filter, exact enumeration, the Kalman filters, MALA, ChEES-HMC, ADVI and
MAP / Laplace over any GenFn; the vmapped and batched filters (``vsmc``),
HMC (``hmc``), NUTS (``nuts``) and the batched MCMC kernels and chains
(``mcmc``) are modules of their own."""

from modppl_tpu_torch.inference.chees import chees, chees_runner
from modppl_tpu_torch.inference.enumerate import (
    auto_supports,
    enumerate_posterior,
)
from modppl_tpu_torch.inference.importance import (
    importance_resampling,
    importance_sampling,
    tree_index,
)
from modppl_tpu_torch.inference.kalman import (
    kalman_filter,
    kalman_filter_parallel,
    kalman_smoother,
    kalman_smoother_parallel,
)
from modppl_tpu_torch.inference.mala import mala
from modppl_tpu_torch.inference.map_laplace import (
    laplace_approximation,
    map_optimize,
)
from modppl_tpu_torch.inference.mh import (
    metropolis_hastings,
    mh,
    regen_mh,
    regenerative_metropolis_hastings,
)
from modppl_tpu_torch.inference.smc import ParticleSystem
from modppl_tpu_torch.inference.vi import advi, advi_fullrank

__all__ = ["ParticleSystem", "advi", "advi_fullrank", "auto_supports",
           "chees", "chees_runner", "enumerate_posterior",
           "importance_resampling", "importance_sampling", "kalman_filter",
           "kalman_filter_parallel", "kalman_smoother",
           "kalman_smoother_parallel", "laplace_approximation", "mala",
           "map_optimize", "metropolis_hastings", "mh", "regen_mh",
           "regenerative_metropolis_hastings", "tree_index"]
