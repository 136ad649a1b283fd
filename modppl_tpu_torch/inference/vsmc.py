"""Batched SMC: the state, its initialisation and the batched-tier particle
filter (counterpart of modppl_tpu/inference/vsmc.py:38-117, 199-337).

The particle axis is an ordinary tensor axis: one generate per step extends
every particle at once, and resampling is one scheme of
``parallel/resample.RESAMPLERS`` plus a gather. Systematic resampling takes
the fused ancestor + state copy (kernel 3) when the state is fusable (float32
on the card, at most 31 columns) and otherwise S -> ``grid_rank`` (kernel 4)
-> ``gather_particles``, as the reference does on a TPU.

Nothing here reads a device value on the host. The reference's ``lax.cond``
on the resample flag becomes both arms and an elementwise ``torch.where`` on
the device flag, as ``parallel/sharded_smc.make_resample_step`` does, so
the kernels launch every step. Proposals and rejuvenation are not ported
yet and raise ``NotImplementedError``.
"""

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import split
from modppl_tpu_torch.parallel.resample import (
    RESAMPLERS,
    fused_systematic_resample_or_none,
    gather_particles,
    systematic_parents,
)
from modppl_tpu_torch.utils.numerics import (
    effective_sample_size_from_log_weights,
    logsumexp,
)

_NOT_PORTED = ("modppl_tpu_torch: guided and rejuvenated filters are not "
               "ported (ROADMAP Queue 1 item 8)")


@dataclass(frozen=True)
class ScanKernel:
    """A state-space model as (init, step) generative functions.

    - ``init``: over args ``(state0,)``, returns the initial state.
    - ``step``: over args ``(t, state)``, ``t >= 1``, returns the next state.
    """

    init: Any
    step: Any


@dataclass
class SMCState:
    """Carry of the filter. Every tensor stays on the filter's device."""

    key: int              # integer PRNG key (core/keys.py)
    state: Any            # per-particle latent state, leading axis N
    log_weights: Any      # (N,)
    log_ml: Any           # 0-dim tensor
    t: int


def batched_smc_init(key, kernel, state0, constraints, num_particles,
                     pool=None):
    """Initialize via ONE generate over a batch-aware init model
    (``kernel.init`` takes args ``(state0, n)``). ``pool`` replaces the
    plate draws of the addresses it holds."""
    k_gen, k_carry = split(key)
    trace, log_weights = kernel.init.generate(
        k_gen, (state0, num_particles), constraints, pool=pool)
    log_ml = torch.zeros((), dtype=log_weights.dtype,
                         device=log_weights.device)
    return SMCState(k_carry, trace.retv, log_weights, log_ml, 1), trace


def _resample(key, s, resampler, ess_threshold, num_particles):
    """Conditional resampling with no host sync: both arms, then a select on
    the device flag ``ess < ess_threshold * N``. Returns (state, parents,
    ess, resampled)."""
    n = num_particles
    log_total = logsumexp(s.log_weights)
    log_norm = s.log_weights - log_total
    ess = effective_sample_size_from_log_weights(log_norm)
    do = ess < ess_threshold * n
    fused = (fused_systematic_resample_or_none(key, log_norm, s.state)
             if resampler is systematic_parents else None)
    if fused is not None:
        state, parents = fused
    else:
        parents = resampler(key, log_norm)
        state = gather_particles(s.state, parents)
    state = pytree.tree_map(lambda a, b: torch.where(do, a, b), state,
                            s.state)
    log_weights = torch.where(do, torch.zeros_like(s.log_weights),
                              s.log_weights)
    log_ml = torch.where(do, s.log_ml + log_total - math.log(float(n)),
                         s.log_ml)
    slots = torch.arange(n, dtype=torch.int32, device=parents.device)
    parents = torch.where(do, parents, slots)
    return SMCState(s.key, state, log_weights, log_ml, s.t), parents, ess, do


def batched_smc_step(s, kernel, constraints_t, num_particles, resampler,
                     ess_threshold, proposal=None, proposal_params=None,
                     rejuvenation=None, rejuvenation_kernel=None):
    """One batched filter step: (maybe) resample, then ONE generate to
    extend every particle. The key splits three ways, as the reference's
    does without rejuvenation. Returns (state, (parents, ess, resampled))."""
    if (proposal is not None or proposal_params is not None
            or rejuvenation is not None or rejuvenation_kernel is not None):
        raise NotImplementedError(_NOT_PORTED)
    key, k_res, k_gen = split(s.key, 3)
    s, parents, ess, resampled = _resample(k_res, s, resampler,
                                           ess_threshold, num_particles)
    trace, w = kernel.step.generate(k_gen, (s.t, s.state), constraints_t)
    new = SMCState(key, trace.retv, s.log_weights + w, s.log_ml, s.t + 1)
    return new, (parents, ess, resampled)


def batched_particle_filter(key, kernel, state0, init_constraints,
                            step_constraints, num_particles,
                            resampling="systematic", ess_threshold=1.0,
                            auto_batch=False, proposal=None,
                            proposal_params=None, rejuvenation=None):
    """The batched-tier bootstrap particle filter on ``state0``'s device.

    ``key`` is an integer PRNG key (core/keys.py). ``kernel`` is an ordinary
    per-particle ScanKernel, wrapped by ``modeling/autobatch`` (only
    ``auto_batch=True`` is ported). ``step_constraints`` is a Trie whose
    values are stacked over the T-1 steps on their leading axis.
    ``resampling`` names a scheme of ``RESAMPLERS``; a step resamples when
    ESS < ``ess_threshold`` * N.

    Returns a dict: ``state``, ``log_weights``, ``log_ml``, ``ancestors``
    ((T-1, N) int32), ``ess`` and ``resampled`` ((T-1,) each), all on the
    device.
    """
    if (proposal is not None or proposal_params is not None
            or rejuvenation is not None):
        raise NotImplementedError(_NOT_PORTED)
    if not auto_batch:
        raise NotImplementedError(
            "modppl_tpu_torch: only auto_batch=True kernels are ported")
    from modppl_tpu_torch.modeling.autobatch import auto_batch_scan_kernel

    if resampling not in RESAMPLERS:
        raise ValueError(f"resampling: expected one of {sorted(RESAMPLERS)}, "
                         f"got {resampling!r}")
    resampler = RESAMPLERS[resampling]
    kernel = auto_batch_scan_kernel(kernel)
    values = step_constraints.values()
    if not values:
        raise ValueError("step_constraints: no per-step values to scan over")
    s, _ = batched_smc_init(key, kernel, state0, init_constraints,
                            num_particles)
    parents, ess, resampled = [], [], []
    for i in range(values[0].shape[0]):
        cons_t = step_constraints.map(lambda v: v[i])
        s, (p, e, r) = batched_smc_step(s, kernel, cons_t, num_particles,
                                        resampler, ess_threshold)
        parents.append(p)
        ess.append(e)
        resampled.append(r)
    log_ml = (s.log_ml + logsumexp(s.log_weights)
              - math.log(float(num_particles)))
    return {"state": s.state, "log_weights": s.log_weights, "log_ml": log_ml,
            "ancestors": torch.stack(parents), "ess": torch.stack(ess),
            "resampled": torch.stack(resampled)}
