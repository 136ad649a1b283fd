"""Inference: importance sampling, Metropolis-Hastings, the eager particle
filter, exact enumeration, the Kalman filters, MALA, ChEES-HMC, ADVI,
MAP / Laplace, particle MCMC (PMMH, particle Gibbs), FIVO, the tempered
SMC samplers, parallel tempering, HMC, NUTS and the checkpointed
drivers; the vmapped and batched filters (``vsmc``), the chain-blocked
filter (``blocked_smc``) and the batched MCMC kernels and chains
(``mcmc``) are modules of their own."""

from modppl_tpu_torch.inference.checkpointed import (
    checkpointed_hmc_runner,
    checkpointed_particle_filter,
    checkpointed_sharded_particle_filter,
)
from modppl_tpu_torch.inference.chees import chees, chees_runner
from modppl_tpu_torch.inference.enumerate import (
    auto_supports,
    enumerate_posterior,
)
from modppl_tpu_torch.inference.hmc import hmc, hmc_runner
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
from modppl_tpu_torch.inference.fivo import fit_proposal, fivo_objective
from modppl_tpu_torch.inference.nuts import nuts, nuts_runner
from modppl_tpu_torch.inference.pgibbs import csmc_sweep, particle_gibbs
from modppl_tpu_torch.inference.pmcmc import (
    gaussian_walk_proposal,
    pmmh,
    pmmh_kernel,
    smc_log_ml_fn,
)
from modppl_tpu_torch.inference.smc import ParticleSystem
from modppl_tpu_torch.inference.smc_sampler import (
    adaptive_smc_sampler,
    smc_sampler,
)
from modppl_tpu_torch.inference.tempering import parallel_tempering
from modppl_tpu_torch.inference.vi import advi, advi_fullrank

__all__ = ["ParticleSystem", "adaptive_smc_sampler", "advi",
           "advi_fullrank", "auto_supports", "checkpointed_hmc_runner",
           "checkpointed_particle_filter",
           "checkpointed_sharded_particle_filter", "chees", "chees_runner",
           "csmc_sweep", "enumerate_posterior", "fit_proposal",
           "fivo_objective", "gaussian_walk_proposal", "hmc", "hmc_runner",
           "importance_resampling", "importance_sampling", "kalman_filter",
           "kalman_filter_parallel", "kalman_smoother",
           "kalman_smoother_parallel", "laplace_approximation", "mala",
           "map_optimize", "metropolis_hastings", "mh", "nuts",
           "nuts_runner", "parallel_tempering", "particle_gibbs", "pmmh",
           "pmmh_kernel", "regen_mh", "regenerative_metropolis_hastings",
           "smc_log_ml_fn", "smc_sampler", "tree_index"]
