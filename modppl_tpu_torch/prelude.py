"""One-stop import (counterpart of modppl_tpu/prelude.py), with ``torch``
in place of ``jax`` and ``jnp``.

    from modppl_tpu_torch.prelude import *
"""

import torch

from modppl_tpu_torch import (
    ArgDiff, GenFn, Selection, Trace, Trie, normalize_addr, select,
    split_addr,
    Distribution, u01, bernoulli, uniform_continuous, uniform,
    uniform_discrete, categorical, normal, mvnormal, geometric, poisson,
    gamma, beta,
    Gen, gen, logsumexp,
)
from modppl_tpu_torch.dists.iid import iid
from modppl_tpu_torch.inference import (
    ParticleSystem, importance_resampling, importance_sampling, mh,
    metropolis_hastings, regen_mh, regenerative_metropolis_hastings,
    tree_index,
)
from modppl_tpu_torch.inference.hmc import hmc
from modppl_tpu_torch.inference.kalman import (
    kalman_filter, kalman_filter_parallel, kalman_smoother,
    kalman_smoother_parallel,
)
from modppl_tpu_torch.inference.mala import mala
from modppl_tpu_torch.inference.nuts import nuts
from modppl_tpu_torch.inference.pgibbs import csmc_sweep, particle_gibbs
from modppl_tpu_torch.inference.pmcmc import gaussian_walk_proposal, pmmh
from modppl_tpu_torch.inference.vi import advi
from modppl_tpu_torch.inference.vsmc import ScanKernel, particle_filter
from modppl_tpu_torch.modeling.combinators import Cond, Switch, tree_select
from modppl_tpu_torch.modeling.unfold import Unfold

__all__ = [
    "torch",
    "ArgDiff", "GenFn", "Selection", "Trace", "Trie",
    "normalize_addr", "select", "split_addr",
    "Distribution", "u01", "bernoulli", "uniform_continuous", "uniform",
    "uniform_discrete", "categorical", "normal", "mvnormal", "geometric",
    "poisson", "gamma", "beta", "iid",
    "Gen", "gen", "logsumexp",
    "ParticleSystem", "importance_sampling", "importance_resampling",
    "metropolis_hastings", "mh", "regenerative_metropolis_hastings",
    "regen_mh", "tree_index",
    "hmc", "nuts", "mala", "advi", "ScanKernel", "particle_filter",
    "pmmh", "gaussian_walk_proposal", "particle_gibbs", "csmc_sweep",
    "kalman_filter", "kalman_filter_parallel", "kalman_smoother",
    "kalman_smoother_parallel",
    "Cond", "Switch", "tree_select", "Unfold",
]
