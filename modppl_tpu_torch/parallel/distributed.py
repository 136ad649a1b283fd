"""Distributed SMC and MCMC over a mesh of shards (counterpart of
modppl_tpu/parallel/distributed.py).

Particles and chains shard over the mesh's ``dp`` axis, one process a
shard (parallel/mesh.py); each rank calls these entry points with the same
arguments, holds its shard of the per-particle or per-chain values, and
gets the replicated ones whole.

1. ``sharded_particle_filter``: the vmapped filter (inference/vsmc.py),
   each rank extending its particles with their global lane keys; a
   resample all-gathers the weights and the state in shard order and
   resamples the whole system on every rank, as one device does, so the
   run is bitwise ``vsmc.particle_filter``'s.
2. ``shardmap_resample_fn``: deterministic cross-shard systematic
   resampling; the weights all-gathered in shard order and reduced alike
   on every shard, so the ancestors are bitwise the same at any dp.
   ``distributed_logsumexp_fn``: the max by ``pmax``, the sum by ``psum``.

Both move O(N) state a shard, as the reference's do; the scalable path is
``parallel/sharded_smc.sharded_batched_particle_filter``, which exchanges
O(N) int32 and O(halo C) rows a shard.

3. ``sharded_hmc``, ``shardmap_hmc`` and ``shardmap_chees``: the chains
   shard over dp, each keyed by its global index, and the pooled
   adaptation crosses shards through ``adaptation._pooled_sum``'s fixed
   add trees, so dp = 1 and dp = k agree.
"""

import math

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import fold_in, split, split_keys
from modppl_tpu_torch.inference import vsmc
from modppl_tpu_torch.modeling.autobatch import _per_particle
from modppl_tpu_torch.modeling.handlers import to_device
from modppl_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    axis_size,
    pmax,
    psum,
)
from modppl_tpu_torch.parallel.mesh import shard_device
from modppl_tpu_torch.parallel.resample import RESAMPLERS, systematic_parents
from modppl_tpu_torch.utils.numerics import logsumexp


def _gathered(tree, axis):
    return pytree.tree_map(lambda x: all_gather(x, axis), tree)


# --------------------------------------------------------------------------
# 1. The vmapped filter over shards
# --------------------------------------------------------------------------

def sharded_particle_filter(mesh, key, kernel, state0, init_constraints,
                            step_constraints, num_particles,
                            resampling="systematic", ess_threshold=1.0,
                            device=None):
    """``inference/vsmc.particle_filter`` (no stored traces) with its
    particles sharded over ``mesh``'s dp axis, on each rank's shard device
    (the card unless ``device`` names another). Particle i is extended with
    its global lane key, as one device keys it; each step all-gathers the
    log-weights and the state in shard order and resamples the whole
    system on every rank, so the run is bitwise the one-device filter's.

    Returns a dict: the shard's ``state`` and ``log_weights``, its
    ``ancestors`` ((T-1, n_local) global indices), and the replicated
    ``log_ml``, ``ess`` and ``resampled``.
    """
    if resampling not in RESAMPLERS:
        raise ValueError(f"resampling: expected one of {sorted(RESAMPLERS)}, "
                         f"got {resampling!r}")
    resampler = RESAMPLERS[resampling]
    n = num_particles
    local = mesh.local(n)
    n_local = local.stop - local.start
    device = shard_device(device)
    state0, init_constraints, step_constraints = to_device(
        (state0, init_constraints, step_constraints), device,
        trie_tensors=True)
    steps = vsmc.num_steps(step_constraints)
    with mesh:
        s, _ = vsmc.smc_init(key, kernel, state0, init_constraints, n_local,
                             offset=local.start)
        ancestors, ess_t, resampled_t = [], [], []
        for i in range(steps):
            key_t, k_res, k_gen, _ = split(s.key, 4)
            whole = vsmc.SMCState(
                s.key, _gathered(s.state, "dp"),
                all_gather(s.log_weights, "dp"), s.log_ml, s.t)
            whole, parents, ess, do, _ = vsmc._resample(
                k_res, whole, resampler, ess_threshold, n)
            keys = split_keys(k_gen, n_local, device, offset=local.start)
            state = pytree.tree_map(lambda x: x[local], whole.state)
            trace, w, _ = vsmc.extend_lanes(
                kernel, keys, s.t, state, step_constraints.map(
                    lambda v: v[i]))
            lw = whole.log_weights[local]
            w = _per_particle(w, n_local, lw.dtype, lw.device)
            s = vsmc.SMCState(key_t, trace.retv, lw + w, whole.log_ml,
                              s.t + 1)
            ancestors.append(parents[local])
            ess_t.append(ess)
            resampled_t.append(do)
        log_ml = (s.log_ml + logsumexp(all_gather(s.log_weights, "dp"))
                  - math.log(float(n)))
    return {"state": s.state, "log_weights": s.log_weights, "log_ml": log_ml,
            "ess": torch.stack(ess_t), "resampled": torch.stack(resampled_t),
            "ancestors": torch.stack(ancestors)}


# --------------------------------------------------------------------------
# 2. Explicit deterministic cross-shard resampling
# --------------------------------------------------------------------------

def shardmap_resample_fn(mesh, axis="dp"):
    """A deterministic cross-shard systematic resampler:
    ``resample(key, log_weights_local, state_local, u=None) ->
    (new_state_local, parents_local, log_total_weight)``, the local tensors
    the shard's slice of the particle axis; ``u`` replaces the uniform
    drawn from ``key``. The weights are all-gathered in shard order and
    reduced alike on every shard, so the global ancestors, and the
    resampled system, are bitwise the same at any shard count."""

    def resample(key, lw_local, state_local, u=None):
        with mesh:
            lw_all = all_gather(lw_local, axis)
            n_local = lw_local.shape[0]
            log_total = logsumexp(lw_all)
            parents = systematic_parents(key, lw_all - log_total, u=u)
            me = axis_index(axis)
            my_parents = parents[me * n_local:(me + 1) * n_local]
            state_all = _gathered(state_local, axis)
            new_state = pytree.tree_map(lambda x: x[my_parents.long()],
                                        state_all)
        return new_state, my_parents, log_total

    return resample


def distributed_logsumexp_fn(mesh, axis="dp"):
    """logsumexp over a vector sharded on ``axis``: the local max, ``pmax``,
    then the local sum of exp and ``psum`` (the backend's add order)."""

    def lse(lw_local):
        with mesh:
            m = pmax(torch.max(lw_local), axis)
            return m + torch.log(psum(torch.sum(torch.exp(lw_local - m)),
                                      axis))

    return lse


# --------------------------------------------------------------------------
# 3. Sharded HMC chains
# --------------------------------------------------------------------------

def _check_chains(mesh, num_chains, axis):
    n_shards = mesh.axis(axis).size
    if num_chains % n_shards:
        raise ValueError(f"num_chains {num_chains} not divisible by "
                         f"{axis}={n_shards}")


def sharded_hmc(mesh, key, model, args, observed, **hmc_kwargs):
    """``inference/hmc.hmc`` with the chain axis sharded over ``mesh``'s dp
    axis (the 10^4-chain configuration): each rank runs its shard's chains,
    pooled adaptation (hmc's default for several chains) across every
    shard. Per-chain outputs are the shard's."""
    from modppl_tpu_torch.inference.hmc import hmc

    _check_chains(mesh, hmc_kwargs.get("num_chains", 1), "dp")
    config = dict(hmc_kwargs)
    config.setdefault("device", None)
    with mesh:
        return hmc(key, model, args, observed, axis_name="dp", **config)


def shardmap_hmc(mesh, key, model, args, observed, *, num_samples=1000,
                 num_warmup=500, num_chains=8, step_size=0.1,
                 num_leapfrog=16, target_accept=0.8, selection=None,
                 axis="dp", device=None):
    """Pooled-adaptation HMC with the chain axis sharded over ``axis``: the
    warmup's pooled dual averaging and Welford mass, then sampling, each
    shard on its chains, the shared (eps, inv_mass) adapted from all
    chains by ``adaptation._pooled_sum``'s fixed add trees. Chain i starts
    from ``split(k_run, num_chains)[i]``'s jitter and draws by its global
    index, so the run is bitwise the same at any power-of-two dp (where
    the model's log-density is bitwise in the batch size). Returns the
    shard's ``samples``, ``logp``, ``accept_prob``, ``divergences`` and
    ``unconstrained`` and the replicated ``step_size`` and ``inv_mass``.
    """
    from modppl_tpu_torch.inference.hmc import (
        _pooled_chains,
        flat_target,
        start_points,
    )
    from modppl_tpu_torch.modeling.handlers import entry_inputs

    _check_chains(mesh, num_chains, axis)
    device, args, observed = entry_inputs(shard_device(device), args,
                                          observed, "shardmap_hmc")
    k_init, k_run = split(key)
    init_trace, _ = model.generate(k_init, args, observed, device=device)
    target = flat_target(model, args, init_trace, observed, selection,
                         device=device)
    with mesh:
        c_local = num_chains // axis_size(axis)
        u0s = start_points(k_run, target.u0, c_local,
                           offset=c_local * axis_index(axis))
        us, logps, aprobs, divs, eps, inv_mass = _pooled_chains(
            fold_in(k_run, 0), target.logprob, u0s, num_warmup, num_samples,
            step_size, num_leapfrog, target_accept, axis_name=axis)
    return {"samples": target.constrain(us), "logp": logps,
            "accept_prob": aprobs, "divergences": divs, "step_size": eps,
            "inv_mass": inv_mass, "unconstrained": us}


def shardmap_chees(mesh, key, model, args, observed, *, num_chains=8,
                   axis="dp", **chees_kwargs):
    """ChEES-HMC with the chain axis sharded over ``axis``: the pooled
    trajectory length, step size and mass cross shards through the fixed
    add trees, and the chains draw by their global indices, so dp = 1 and
    dp = k agree. Returns the shard's per-chain values and the replicated
    ``step_size``, ``trajectory_length`` and ``num_leapfrog``."""
    from modppl_tpu_torch.inference.chees import chees_runner

    _check_chains(mesh, num_chains, axis)
    k_init, k_run = split(key)
    runner = chees_runner(model, args, observed, num_chains=num_chains,
                          axis_name=axis, setup_key=k_init, **chees_kwargs)
    with mesh:
        return runner(k_run)
