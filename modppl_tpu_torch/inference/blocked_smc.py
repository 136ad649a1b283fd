"""C independent particle filters as ONE filter over C N lanes.

PMMH (inference/pmcmc.py) estimates every chain's likelihood a step, and
FIVO (inference/fivo.py) averages a batch of independent runs; the
reference ``vmap``s one filter over them. Here chain c owns the block of
lanes [c N, (c + 1) N) of one particle axis, and each step runs the kernel
once over all C N lanes:

- keys: chain c's filter is keyed by its own lane key, with the vmapped
  filter's splits (inference/vsmc.py) taken lane by lane, so chain c's run
  depends on its key alone, never on C. With ``auto_batch=False`` (the
  vmapped tier) particle i of chain c is keyed ``split(k_c, N)[i]``, as the
  one-chain ``particle_filter`` keys it; with ``auto_batch=True`` (the
  batched tier) a site draws each chain's N values as one plate from the
  chain's stream for that address (``Distribution.sample_lanes`` with
  ``block=N``);
- weights: each chain normalizes, takes its ESS and its log-ML over its own
  row of the (C, N) weights, and decides to resample on its own; the
  decision is broadcast to its block;
- resampling: ``parallel/resample.blocked_resample``, each chain among its
  own particles, systematic S through one launch of kernel 3 a step for
  every chain (the state permitting), both arms every step with a select
  on the device, as ``vsmc._resample`` does.

``replay`` carries a run's draws as the vmapped filter's does
(inference/vsmc.py): ``(None, pool)`` for the init, then ``(u, pool)`` or
``(u, pool, proposal_pool, None)`` a step (there are no moves), ``u`` the
chains' resample uniforms ((C,) systematic and residual, else (C, N)) and
each pool's values over all C N lanes.

Nothing is read back to the host, and nothing on the path detaches: with
parameters that require grad, the log-MLs carry their gradients through
the reparameterized draws and kernel 3's backward.
"""

import math

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import (
    fold_in_lanes,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.inference.vsmc import (
    extend,
    extend_lanes,
    num_steps,
    replay_entry,
    wrap_kernel,
)
from modppl_tpu_torch.modeling.autobatch import _per_particle
from modppl_tpu_torch.modeling.handlers import (
    entry_device,
    infer_dtype_device,
    to_device,
)
from modppl_tpu_torch.parallel.resample import (
    BLOCKED_SCHEMES,
    blocked_resample,
)


def particle_keys(chain_keys, num_particles):
    """(C N,) lane keys: lane c N + i is ``split(chain_keys[c], N)[i]``."""
    i = torch.arange(num_particles, dtype=torch.int64,
                     device=chain_keys.device) + (1 << 32)
    return fold_in_lanes(chain_keys[:, None], i).reshape(-1)


def _blocked_weights(log_weights, c):
    """(C, N) normalized log-weights, the (C,) log totals and ESS."""
    lw = log_weights.reshape(c, -1)
    log_total = torch.logsumexp(lw, 1)
    log_norm = lw - log_total[:, None]
    ess = torch.exp(-torch.logsumexp(2.0 * log_norm, 1))
    return log_norm, log_total, ess


def _resample_blocks(k_res, scheme, state, log_weights, log_ml,
                     ess_threshold, n, u=None):
    """Both arms and a select, each chain on its own flag; ``u`` replaces
    the uniforms drawn from ``k_res``. Returns (state, log_weights, log_ml,
    parents, ess, resampled)."""
    c = log_ml.shape[0]
    log_norm, log_total, ess = _blocked_weights(log_weights, c)
    do = ess < ess_threshold * n
    if ess_threshold <= 0:
        # no chain can resample (ESS >= 0): the select would keep every
        # chain's state, so the arm is not run
        slots = torch.arange(c * n, dtype=torch.int32, device=ess.device)
        return state, log_weights, log_ml, slots, ess, do
    shape = () if scheme in ("systematic", "residual") else (n,)
    u = (uniform_lanes(k_res, shape, log_norm.dtype) if u is None
         else u.reshape((c,) + shape))
    new, parents = blocked_resample(scheme, log_norm, state, u)
    lanes = do.repeat_interleave(n)

    def pick(a, b):
        return torch.where(lanes.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    state = pytree.tree_map(pick, new, state)
    log_weights = torch.where(lanes, torch.zeros_like(log_weights),
                              log_weights)
    log_ml = torch.where(do, log_ml + log_total - math.log(float(n)), log_ml)
    slots = torch.arange(c * n, dtype=torch.int32, device=parents.device)
    return (state, log_weights, log_ml, torch.where(lanes, parents, slots),
            ess, do)


def blocked_particle_filter(chain_keys, kernel, state0, init_constraints,
                            step_constraints, num_particles,
                            resampling="systematic", ess_threshold=1.0,
                            auto_batch=False, proposal=None,
                            proposal_params=None, replay=None, device=None):
    """C = ``len(chain_keys)`` independent filters of ``num_particles``
    each, in one filter over C N lanes (see the module docstring), on the
    card unless ``device`` names another.

    ``chain_keys`` is a (C,) int64 tensor of lane keys (core/keys.py),
    one a chain. ``kernel`` is a per-particle ScanKernel whose functions
    may close over per-lane parameters (leading axis C N, chain c's in its
    block). ``state0`` and the constraints are shared by every chain.
    ``resampling`` is one of ``parallel/resample.BLOCKED_SCHEMES``;
    ``proposal`` / ``proposal_params`` as in ``vsmc.particle_filter``;
    ``replay`` as in the module docstring.

    Returns a dict: ``state`` (leading axis C N), ``log_weights`` (C, N),
    ``log_ml`` (C,), ``ancestors`` ((T-1, C N) int32 on the shared axis),
    ``ess`` and ``resampled`` ((T-1, C) each).
    """
    device = entry_device(device, "blocked_particle_filter")
    if resampling not in BLOCKED_SCHEMES:
        raise ValueError(f"resampling: expected one of {BLOCKED_SCHEMES} "
                         f"for chain-blocked filters, got {resampling!r}")
    if auto_batch:
        kernel, proposal = wrap_kernel(kernel, proposal, None, True,
                                       "blocked_particle_filter")
    chain_keys, state0, init_constraints, step_constraints, proposal_params = \
        to_device((chain_keys, state0, init_constraints, step_constraints,
                   proposal_params), device, trie_tensors=True)
    c, n = chain_keys.shape[0], num_particles
    n_lanes = c * n
    steps = num_steps(step_constraints, replay)
    k_sim, key = split_lanes(chain_keys, 2).unbind(-1)
    pool = replay[0][1] if replay else None
    if auto_batch:
        trace, log_weights = kernel.init.generate(
            k_sim, (state0, n_lanes), init_constraints, pool=pool)
    else:
        trace, log_weights = kernel.init.generate(
            particle_keys(k_sim, n), (state0,), init_constraints, pool=pool)
    dtype, _ = infer_dtype_device((state0,), device)
    log_weights = _per_particle(log_weights, n_lanes, dtype, device)
    state = trace.retv
    log_ml = torch.zeros(c, dtype=log_weights.dtype, device=device)
    parents, ess, resampled = [], [], []
    for i in range(steps):
        if auto_batch:
            key, k_res, k_gen = split_lanes(key, 3).unbind(-1)
        else:
            key, k_res, k_gen, _ = split_lanes(key, 4).unbind(-1)
        u, pool, proposal_pool, _ = replay_entry(
            replay[i + 1] if replay else None)
        state, log_weights, log_ml, p, e, r = _resample_blocks(
            k_res, resampling, state, log_weights, log_ml, ess_threshold, n,
            u=u)
        cons_t = step_constraints.map(lambda v: v[i])
        if auto_batch:
            trace, w, _ = extend(kernel, k_gen, i + 1, state, cons_t,
                                 n_lanes, proposal, proposal_params,
                                 pool=pool, proposal_pool=proposal_pool)
        else:
            trace, w, _ = extend_lanes(kernel, particle_keys(k_gen, n),
                                       i + 1, state, cons_t, proposal,
                                       proposal_params, pool=pool,
                                       proposal_pool=proposal_pool)
        state = trace.retv
        log_weights = log_weights + _per_particle(
            w, n_lanes, log_weights.dtype, device)
        parents.append(p)
        ess.append(e)
        resampled.append(r)
    lw = log_weights.reshape(c, n)
    log_ml = log_ml + torch.logsumexp(lw, 1) - math.log(float(n))
    return {"state": state, "log_weights": lw, "log_ml": log_ml,
            "ancestors": torch.stack(parents), "ess": torch.stack(ess),
            "resampled": torch.stack(resampled)}
