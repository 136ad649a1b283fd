"""Particle MCMC: particle-marginal Metropolis-Hastings (counterpart of
modppl_tpu/inference/pmcmc.py).

Pseudo-marginal MCMC over state-space-model parameters: the intractable
p(y | theta) in the MH ratio is replaced by an unbiased SMC estimate, and
the chain still targets the exact parameter posterior (Andrieu, Doucet &
Holenstein 2010).

**The port's contract.** The reference ``vmap``s whole chains, each with a
particle filter inside every MH step. The port runs every chain's estimate
in ONE filter over C N lanes and never loops over chains in Python, so the
functions a caller supplies work on all chains at once:

- ``theta`` is a pytree whose leaves carry a leading (C,) chain axis;
- ``log_ml_fn(key_lanes, theta)`` takes the (C,) int64 lane keys
  (core/keys.py) and returns the (C,) estimates, chain c's a function of
  ``key_lanes[c]`` and its own theta alone;
- ``proposal(key_lanes, theta)`` returns the proposed pytree, each chain
  from its own key;
- ``log_prior_fn(theta)`` maps over the chain axis, (C,) log densities
  (``-inf`` outside the support).

``smc_log_ml_fn`` builds such an estimator from a theta-parameterized
ScanKernel factory: lane c N + i of its filter carries chain c's theta, and
the chains resample each among their own particles
(inference/blocked_smc.py: systematic S through one launch of kernel 3 a
step for all chains). Keys follow the reference's layout per chain
(``split(key, C)``, then ``split(k, 3)`` for the start and ``split(k_run,
num_samples)`` for the iterations, each split into proposal, estimate and
accept keys), taken lane by lane, so chain i's run does not depend on C.
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import (
    fold_in_lanes,
    normal_lanes,
    split_keys,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.inference.blocked_smc import blocked_particle_filter
from modppl_tpu_torch.modeling.handlers import entry_device, to_device


def gaussian_walk_proposal(step_sizes):
    """Symmetric random-walk proposal over a theta pytree (leaves with a
    leading chain axis). ``step_sizes`` is a number or a pytree of per-leaf
    standard deviations, broadcast against each chain's leaf; leaf j of
    chain c moves by ``normal_lanes(split(key_c, L)[j])``."""

    def propose(key_lanes, theta):
        leaves, spec = pytree.tree_flatten(theta)
        if isinstance(step_sizes, (int, float)):
            steps = [step_sizes] * len(leaves)
        else:
            steps = pytree.tree_leaves(step_sizes)
        keys = split_lanes(key_lanes, len(leaves)).unbind(-1)
        new = [x + s * normal_lanes(k, tuple(x.shape[1:]), x.dtype)
               for x, s, k in zip(leaves, steps, keys)]
        return pytree.tree_unflatten(new, spec)

    return propose


def _select(pred, a, b):
    """Leaf by leaf, chain c's ``a`` where ``pred[c]`` else its ``b``."""
    return pytree.tree_map(lambda x, y: torch.where(
        pred.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), a, b)


def _repeat_lanes(theta, n):
    """Each chain's theta repeated over its block of n lanes."""
    return pytree.tree_map(lambda x: x.repeat_interleave(n, dim=0), theta)


def smc_log_ml_fn(make_kernel, state0, init_constraints, step_constraints,
                  num_particles, *, resampling="systematic",
                  ess_threshold=1.0, auto_batch=False, device=None):
    """A ``log_ml_fn(key_lanes, theta) -> (C,)`` for :func:`pmmh`: one
    chain-blocked filter over C N lanes, lane c N + i carrying chain c's
    theta, on the card unless ``device`` names another.

    ``make_kernel(theta_lanes)`` returns a per-particle ScanKernel whose
    functions close over per-lane parameters (leaves of leading axis C N).
    ``auto_batch=True`` takes the batched tier (one stream a site a chain),
    ``False`` the vmapped tier (one stream a particle); either way chain
    c's estimate depends only on its key and its theta.
    """
    device = entry_device(device, "smc_log_ml_fn")
    state0, init_constraints, step_constraints = to_device(
        (state0, init_constraints, step_constraints), device,
        trie_tensors=True)

    def log_ml_fn(key_lanes, theta):
        kernel = make_kernel(_repeat_lanes(theta, num_particles))
        out = blocked_particle_filter(
            key_lanes, kernel, state0, init_constraints, step_constraints,
            num_particles, resampling=resampling,
            ess_threshold=ess_threshold, auto_batch=auto_batch,
            device=device)
        return out["log_ml"]

    return log_ml_fn


def pmmh_kernel(log_prior_fn, log_ml_fn, proposal):
    """One PMMH transition of every chain over the carry ``(theta,
    log_post_hat)``. The carried ``log_post_hat = log_prior + log_ml_hat``
    reuses the stored estimate for the current point (the pseudo-marginal
    construction).

    ``kernel(key_lanes, carry, u=None)`` returns ``(carry, accept)``; ``u``
    replaces the (C,) accept uniforms. The estimator always runs, for every
    chain, and a proposal outside the support is masked to ``-inf``
    afterwards (pmcmc.py:105-112): ``log_ml_fn`` must stay total there,
    returning a finite or NaN value, and the chain-blocked filter keeps a
    NaN chain from touching the others.
    """

    def kernel(key_lanes, carry, u=None):
        theta, log_post = carry
        k_prop, k_ml, k_acc = split_lanes(key_lanes, 3).unbind(-1)
        theta_new = proposal(k_prop, theta)
        lp_new = log_prior_fn(theta_new)
        log_ml_new = torch.where(torch.isfinite(lp_new),
                                 log_ml_fn(k_ml, theta_new), -torch.inf)
        log_post_new = lp_new + log_ml_new
        if u is None:
            u = uniform_lanes(k_acc, (), log_post.dtype)
        accept = torch.log(u) < log_post_new - log_post
        theta = _select(accept, theta_new, theta)
        log_post = torch.where(accept, log_post_new, log_post)
        return (theta, log_post), accept

    return kernel


def pmmh(key, log_prior_fn, log_ml_fn, theta0, *, num_samples,
         num_chains=1, proposal=None, step_size=0.1, device=None):
    """Run ``num_chains`` PMMH chains at once, on the card unless
    ``device`` names another.

    ``key`` is an integer key; ``theta0`` an unbatched theta pytree, which
    each chain perturbs with one proposal step so that chains do not start
    alike. ``proposal`` defaults to ``gaussian_walk_proposal(step_size)``.
    See the module docstring for the batched contract of ``log_prior_fn``,
    ``log_ml_fn`` and ``proposal``.

    Returns {"samples": theta pytree (num_chains, num_samples, ...),
    "accept_rate": (num_chains,), "final": the last theta (num_chains,
    ...), "log_post": (num_chains,)}, all on the device.
    """
    device = entry_device(device, "pmmh")
    prop = proposal if proposal is not None else gaussian_walk_proposal(
        step_size)
    kernel = pmmh_kernel(log_prior_fn, log_ml_fn, prop)
    theta0 = to_device(pytree.tree_map(torch.as_tensor, theta0), device)
    chains = split_keys(key, num_chains, device)
    k_init, k_ml0, k_run = split_lanes(chains, 3).unbind(-1)
    theta = prop(k_init, pytree.tree_map(
        lambda x: x.expand((num_chains,) + tuple(x.shape)), theta0))
    log_post = log_prior_fn(theta) + log_ml_fn(k_ml0, theta)
    carry = (theta, log_post)
    samples, accepts = [], []
    for i in range(num_samples):
        carry, accept = kernel(fold_in_lanes(k_run, (1 << 32) + i), carry)
        samples.append(carry[0])
        accepts.append(accept)
    accept = torch.stack(accepts, dim=1)
    return {
        "samples": pytree.tree_map(lambda *xs: torch.stack(xs, dim=1),
                                   *samples),
        "accept_rate": accept.to(torch.float32).mean(dim=1),
        "final": carry[0],
        "log_post": carry[1],
    }
