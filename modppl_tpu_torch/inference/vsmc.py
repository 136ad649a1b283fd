"""Batched SMC state and initialisation (counterpart of
modppl_tpu/inference/vsmc.py:38-68, 199-214)."""

from dataclasses import dataclass
from typing import Any

import torch

from modppl_tpu_torch.core.keys import split


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
