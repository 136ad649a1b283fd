"""FIVO / variational SMC: learn a proposal's parameters by gradient ascent
on the filter's log-marginal-likelihood estimate (counterpart of
modppl_tpu/inference/fivo.py).

The filter's ``log_ml`` is differentiable in the proposal's parameters when
the proposal samples reparameterizably (x = mu + std z): ascending it
tightens the FIVO bound E[log Z_hat] <= log Z. Gradients flow through the
weights and the proposed samples; the ancestors are integers, so their
selection is a stop-gradient, while the gathered states carry the
gradient back to their ancestors (kernel 3's backward on the card,
ops/fused_resample.py). Nothing on the filter's path detaches or reads a
value back to the host.

One code path serves both entries, as the reference's ``fit_proposal``
``vmap``s its ``fivo_objective``: the objective is the one-chain case of
the chain-blocked filter (inference/blocked_smc.py), keyed by ``key`` as
its one lane, and ``fit_proposal``'s ``batch_size`` runs a step are that
filter over ``batch_size`` chains, run b keyed as ``fivo_objective`` is by
``split(k_s, batch_size)[b]``. So ``resampling`` is one of the blocked
filter's schemes (``parallel/resample.BLOCKED_SCHEMES``), the reference's
four: ``"residual"`` runs each chain's deterministic copies and residual
sweep inside the chain's own block of lanes. The optimizer is the port's
optax Adam (inference/_adam.py) on the negated gradients.
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import key_lane, split, split_keys
from modppl_tpu_torch.inference._adam import adam_init, adam_step
from modppl_tpu_torch.inference.blocked_smc import blocked_particle_filter
from modppl_tpu_torch.modeling.handlers import entry_device, to_device


def fivo_objective(key, kernel, proposal, params, state0, init_constraints,
                   step_constraints, num_particles, resampling="multinomial",
                   ess_threshold=1.0, auto_batch=False, replay=None,
                   device=None):
    """The stochastic FIVO bound: the log-ML of one guided filter run (a
    0-dim tensor carrying the gradient of ``params``), on the card unless
    ``device`` names another. ``auto_batch=True`` takes the batched tier,
    else the vmapped one. ``replay`` carries the run's draws
    (``blocked_particle_filter``'s, one chain)."""
    device = entry_device(device, "fivo_objective")
    out = blocked_particle_filter(
        key_lane(key, device), kernel, state0, init_constraints,
        step_constraints, num_particles, resampling=resampling,
        ess_threshold=ess_threshold, auto_batch=auto_batch,
        proposal=proposal, proposal_params=params, replay=replay,
        device=device)
    return out["log_ml"][0]


def fit_proposal(key, kernel, proposal, params0, state0, init_constraints,
                 step_constraints, num_particles, *, num_steps=200,
                 learning_rate=0.05, batch_size=1, resampling="multinomial",
                 ess_threshold=1.0, auto_batch=False, replay=None,
                 device=None):
    """Optimize the proposal's parameters by ascending the FIVO bound, on
    the card unless ``device`` names another.

    ``proposal`` is a @gen over ``(t, state, constraints_t, params)``;
    ``params0`` a pytree of tensors. Step s takes the key ``split(key,
    num_steps)[s]`` and averages ``batch_size`` runs keyed ``split(k_s,
    batch_size)``, the reference's layout, in one chain-blocked filter.
    ``replay``, one entry a step, carries each step's draws over its
    ``batch_size`` chains (``blocked_particle_filter``'s). The optimizer
    is optax's Adam at ``learning_rate`` (the reference's ``optimizer=`` is
    not ported). Returns (params, bounds): the optimized pytree and the
    (num_steps,) batch-mean bounds.
    """
    device = entry_device(device, "fit_proposal")
    if replay is not None and len(replay) != num_steps:
        raise ValueError(f"replay: expected {num_steps} entries, got "
                         f"{len(replay)}")
    leaves, spec = pytree.tree_flatten(to_device(
        pytree.tree_map(torch.as_tensor, params0), device))
    params = tuple(p.detach() for p in leaves)
    state = adam_init(params)
    bounds = []
    for s, k in enumerate(split(key, num_steps)):
        ps = tuple(p.requires_grad_() for p in params)
        out = blocked_particle_filter(
            split_keys(k, batch_size, device), kernel, state0,
            init_constraints, step_constraints, num_particles,
            resampling=resampling, ess_threshold=ess_threshold,
            auto_batch=auto_batch, proposal=proposal,
            proposal_params=pytree.tree_unflatten(list(ps), spec),
            replay=replay[s] if replay else None, device=device)
        bound = torch.mean(out["log_ml"])
        grads = torch.autograd.grad(bound, ps)
        with torch.no_grad():
            # ascend: negate the gradients for the minimizing optimizer
            params, state = adam_step(ps, tuple(-g for g in grads), state,
                                      learning_rate)
        params = tuple(p.detach() for p in params)
        bounds.append(bound.detach())
    return pytree.tree_unflatten(list(params), spec), torch.stack(bounds)
