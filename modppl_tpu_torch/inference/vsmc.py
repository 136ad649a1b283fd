"""Batched SMC: the state, its initialisation, the vmapped filter and the
batched-tier particle filter, bootstrap, guided and rejuvenated
(counterpart of modppl_tpu/inference/vsmc.py).

Two tiers. The vmapped one (``smc_init``, ``smc_step``,
``particle_filter``) is the reference's ``vmap`` over particles: particle
i is keyed by its own lane (``split(k, N)[i]``, core/keys.py) and the
per-particle kernel runs ONCE over the lane axis with lane keys
(modeling/handlers.py), so particle i's draws are those of its key alone.
The batched tier (``batched_smc_init``, ``batched_smc_step``,
``batched_particle_filter``) runs a site once for every particle, particle
i drawing from its own lane stream keyed by its global index
(modeling/autobatch.py), so a shard of the particles draws what one device
draws for them.

The particle axis is an ordinary tensor axis: one generate per step extends
every particle at once, and resampling is one scheme of
``parallel/resample.RESAMPLERS`` plus a gather. Systematic resampling takes
the fused ancestor + state copy (kernel 3) when the state is fusable (float32
on the card, at most 31 columns) and otherwise S -> ``grid_rank`` (kernel 4)
-> ``gather_particles``, as the reference does on a TPU.

A guided step proposes every particle's choices with one batched
``propose``, merges them into the step's observations and weighs by
``model weight - proposal logjp``. Rejuvenation runs regenerative MH moves
on the selected addresses of the step's batched trace, each particle
accepting by ``log(u) < w`` (resample-move; the log-ML is untouched).

Nothing here reads a device value on the host. The reference's ``lax.cond``
on the resample flag becomes both arms and an elementwise ``torch.where`` on
the device flag, as ``parallel/sharded_smc.make_resample_step`` does, so
the kernels launch every step.

``replay`` and ``record`` carry a run's draws, one entry a step: ``(u,
pool)``, the resample uniform(s) and the generate's draws by address (``u``
None for the init), and with a proposal or rejuvenation ``(u, pool,
proposal_pool, moves)``, ``moves`` one ``(pool, accept_u)`` a move.
"""

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.gfi import ArgDiff, Trace
from modppl_tpu_torch.core.keys import (
    fold_in,
    fold_in_lanes,
    lanes,
    split,
    split_keys,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.mcmc import _split, tree_select
from modppl_tpu_torch.modeling.autobatch import _per_particle
from modppl_tpu_torch.modeling.handlers import (
    entry_device,
    infer_dtype_device,
    to_device,
)
from modppl_tpu_torch.ops.resample import uniform
from modppl_tpu_torch.parallel.resample import (
    RESAMPLERS,
    fused_systematic_resample_or_none,
    gather_particles,
    residual_parents,
    systematic_parents,
)
from modppl_tpu_torch.utils.numerics import (
    effective_sample_size_from_log_weights,
    logsumexp,
)
from modppl_tpu_torch.utils.profiling import annotate


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


def replay_entry(entry):
    """A replay entry as ``(u, pool, proposal_pool, moves)``."""
    if entry is None:
        return None, None, None, None
    u, pool, *rest = entry
    proposal_pool, moves = rest if rest else (None, None)
    return u, pool, proposal_pool, moves


def generated_draws(trace, constraints):
    """The values a generate drew (its unconstrained addresses)."""
    return {a: trace.data[a] for a in trace.data.addresses()
            if a not in constraints}


def tier_call(part, key, n, offset, args):
    """The key and keyword arguments of a batched-tier call of ``part``
    (a kernel's init or step) over ``n`` particles from the global index
    ``offset``: an auto-batched part takes the host key and the offset; a
    batch-aware one the particles' lane keys (``lanes(key, n, device,
    offset)`` on the device of ``args``), so its plate sites draw one lane
    a particle; a (C,) tensor of chain keys goes as it is
    (inference/blocked_smc.py)."""
    from modppl_tpu_torch.modeling.autobatch import (
        AutoBatchedInit,
        AutoBatchedStep,
    )

    if isinstance(part, (AutoBatchedInit, AutoBatchedStep)):
        return key, {"offset": offset}
    if torch.is_tensor(key):
        return key, {}
    return lanes(key, n, infer_dtype_device(args)[1], offset=offset), {}


def batched_smc_init(key, kernel, state0, constraints, num_particles,
                     pool=None, offset=0):
    """Initialize via ONE generate over a batch-aware init model
    (``kernel.init`` takes args ``(state0, n)``). ``pool`` replaces the
    draws of the addresses it holds; the particles start at the global
    index ``offset`` (:func:`tier_call`)."""
    k_gen, k_carry = split(key)
    with annotate("modppl.extend"):
        k, kw = tier_call(kernel.init, k_gen, num_particles, offset,
                          (state0,))
        trace, log_weights = kernel.init.generate(
            k, (state0, num_particles), constraints, pool=pool, **kw)
    log_ml = torch.zeros((), dtype=log_weights.dtype,
                         device=log_weights.device)
    return SMCState(k_carry, trace.retv, log_weights, log_ml, 1), trace


def _resample(key, s, resampler, ess_threshold, num_particles, u=None):
    """Conditional resampling with no host sync: both arms, then a select on
    the device flag ``ess < ess_threshold * N``. ``u`` replaces the
    uniform(s) drawn from ``key``. Returns (state, parents, ess, resampled,
    u)."""
    n = num_particles
    log_total = logsumexp(s.log_weights)
    log_norm = s.log_weights - log_total
    ess = effective_sample_size_from_log_weights(log_norm)
    do = ess < ess_threshold * n
    one = resampler in (systematic_parents, residual_parents)
    if u is None:
        u = uniform(key, log_norm, () if one else (n,))
    fused = (fused_systematic_resample_or_none(key, log_norm, s.state, u=u)
             if resampler is systematic_parents else None)
    if fused is not None:
        state, parents = fused
    else:
        parents = resampler(key, log_norm, **({"u": u} if one else {"us": u}))
        state = gather_particles(s.state, parents)
    state = pytree.tree_map(lambda a, b: torch.where(do, a, b), state,
                            s.state)
    log_weights = torch.where(do, torch.zeros_like(s.log_weights),
                              s.log_weights)
    log_ml = torch.where(do, s.log_ml + log_total - math.log(float(n)),
                         s.log_ml)
    slots = torch.arange(n, dtype=torch.int32, device=parents.device)
    parents = torch.where(do, parents, slots)
    return (SMCState(s.key, state, log_weights, log_ml, s.t), parents, ess,
            do, u)


def extend(kernel, key, t, state, constraints_t, num_particles,
           proposal=None, proposal_params=None, pool=None,
           proposal_pool=None, offset=0):
    """ONE generate that extends every particle: bootstrap, or guided by a
    batched ``proposal`` (``propose(key, (t, state, constraints_t[,
    params]), n) -> (choices, logjp)``); ``key`` is a host key, or a (C,)
    tensor of chain keys whose site draws cover blocks of particles
    (inference/blocked_smc.py). The observations are broadcast to
    the particle axis as views, merged with the proposed choices and
    constrain a per-particle generate; the weight is ``model weight -
    proposal logjp``. The particles start at the global index ``offset``
    (:func:`tier_call`). Returns (trace, weight, proposed choices or
    None)."""
    n = num_particles
    if proposal is None:
        k, kw = tier_call(kernel.step, key, n, offset, (state,))
        trace, w = kernel.step.generate(k, (t, state), constraints_t,
                                        pool=pool, **kw)
        return trace, w, None
    k_prop, k_mod = _split(key, 2)
    pargs = ((t, state, constraints_t) if proposal_params is None
             else (t, state, constraints_t, proposal_params))
    pchoices, plogjp = proposal.propose(k_prop, pargs, n, pool=proposal_pool,
                                        offset=offset)
    cons = constraints_t.map(lambda x: x.expand((n,) + tuple(x.shape)))
    cons.merge(pchoices)
    trace, mw = kernel.step.generate_constrained_batched(
        k_mod, (t, state), cons, pool=pool, offset=offset)
    return trace, mw - plogjp, pchoices


def extend_lanes(kernel, keys, t, state, constraints_t, proposal=None,
                 proposal_params=None, pool=None, proposal_pool=None):
    """The vmapped tier's extend: ONE generate of ``kernel.step`` over the
    per-particle lane keys ``keys``, bootstrap or guided by ``proposal``
    (particle i's lane split into the proposal's key and the model's).
    Returns (trace, weight, the proposed choices by address or None)."""
    if proposal is None:
        trace, w = kernel.step.generate(keys, (t, state), constraints_t,
                                        pool=pool)
        return trace, w, None
    k_p, k_m = split_lanes(keys, 2).unbind(-1)
    pargs = ((t, state, constraints_t) if proposal_params is None
             else (t, state, constraints_t, proposal_params))
    ptrace = proposal.simulate(k_p, pargs, pool=proposal_pool)
    cons = constraints_t.copy()
    cons.merge(ptrace.data)
    trace, w = kernel.step.generate(k_m, (t, state), cons, pool=pool)
    return (trace, w - ptrace.logjp,
            {a: ptrace.data[a] for a in ptrace.data.addresses()})


def _rejuvenate(key, trace, kernel, selection, num_moves, moves=None,
                record=None, offset=0):
    """Resample-move rejuvenation: ``num_moves`` regenerative-MH moves of
    every particle over ``selection`` in the step's batched trace. Move r
    takes ``fold_in(key, r)``, split into the regenerate's key and the
    accept uniforms' key; particle i's accept uniform is drawn from
    ``fold_in(k_acc, offset + i)``, its global index. ``moves`` replays
    ``(pool, accept_u)`` a move; ``record`` receives them. Returns (trace,
    the accept flags of each move)."""
    # a selection outside the kernel's address set would silently no-op
    missing = [a for a in selection.leaf_addresses()
               if trace.data.search(a) is None]
    if missing:
        raise ValueError(
            f"rejuvenation: selection addresses {missing} not in the step "
            f"kernel's trace (has {trace.data.addresses()})")
    accepts = []
    for r in range(num_moves):
        pool, u = moves[r] if moves else (None, None)
        k_regen, k_acc = split(fold_in(key, r))
        drawn = {}
        new, w = kernel.step.regenerate(k_regen, trace, trace.args,
                                        ArgDiff.NO_CHANGE, selection,
                                        pool=pool, drawn=drawn, offset=offset)
        if u is None:
            u = uniform_lanes(lanes(k_acc, w.shape[0], w.device,
                                    offset=offset), (), w.dtype)
        accept = torch.log(u) < w
        trace = tree_select(accept, new, trace)
        accepts.append(accept)
        if record is not None:
            record.append((drawn, u))
    return trace, accepts


def guided_step(s, kernel, k_gen, k_rej, constraints_t, num_particles,
                proposal, proposal_params, rejuvenation, entry, record=False,
                offset=0):
    """Extend (bootstrap or guided) and rejuvenate the resampled carry
    ``s``, one filter step's model half, over ``num_particles`` particles
    from the global index ``offset``. ``entry`` replays ``(pool, proposal_pool,
    moves)`` (each None to draw). Returns (trace, weight, the per-particle
    accept flags of each move stacked (num_moves, n) or None, and with
    ``record`` the step's record entry less its resample uniform:
    ``(pool,)`` for a bootstrap step, else ``(pool, proposal_pool,
    moves)``; None without)."""
    pool, proposal_pool, moves = entry
    trace, w, pchoices = extend(kernel, k_gen, s.t, s.state, constraints_t,
                                num_particles, proposal, proposal_params,
                                pool=pool, proposal_pool=proposal_pool,
                                offset=offset)
    draws, moved = None, None
    if record:
        proposed = {} if pchoices is None else {
            a: pchoices[a] for a in pchoices.addresses()}
        drawn = generated_draws(trace, constraints_t.addresses() + list(
            proposed))
        moved = []
        draws = ((drawn,) if proposal is None and rejuvenation is None
                 else (drawn, None if pchoices is None else proposed, moved))
    acceptance = None
    if rejuvenation is not None:
        selection, num_moves = rejuvenation
        trace, accepts = _rejuvenate(k_rej, trace, kernel, selection,
                                     num_moves, moves=moves, record=moved,
                                     offset=offset)
        acceptance = torch.stack(accepts)
    return trace, w, acceptance, draws


def batched_smc_step(s, kernel, constraints_t, num_particles, resampler,
                     ess_threshold, proposal=None, proposal_params=None,
                     rejuvenation=None, replay=None, record=None):
    """One batched filter step: (maybe) resample, then ONE generate to
    extend every particle, optionally guided and rejuvenated. The key splits
    three ways, as the reference's does; the rejuvenation key is
    ``fold_in(s.key, 3)``, derived only when used. ``replay``: one entry of
    the filter's; ``record``: a list the step appends its entry to. Returns
    (state, (parents, ess, resampled, acceptance))."""
    key, k_res, k_gen = split(s.key, 3)
    k_rej = fold_in(s.key, 3) if rejuvenation is not None else None
    u, *entry = replay_entry(replay)
    s, parents, ess, resampled, u = _resample(
        k_res, s, resampler, ess_threshold, num_particles, u=u)
    trace, w, accepts, draws = guided_step(
        s, kernel, k_gen, k_rej, constraints_t, num_particles, proposal,
        proposal_params, rejuvenation, entry, record=record is not None)
    if record is not None:
        record.append((u, *draws))
    new = SMCState(key, trace.retv, s.log_weights + w, s.log_ml, s.t + 1)
    acceptance = (None if accepts is None
                  else accepts.to(w.dtype).mean(dim=1))
    return new, (parents, ess, resampled, acceptance)


def wrap_kernel(kernel, proposal, rejuvenation, auto_batch, what):
    """The batched-tier kernel and proposal: an ordinary per-particle
    ScanKernel and proposal wrapped by ``modeling/autobatch``, or a
    batch-aware kernel as given (which takes neither a proposal nor
    rejuvenation: the guided weights and the moves come from the
    per-particle kernel)."""
    if not auto_batch:
        if proposal is not None or rejuvenation is not None:
            raise ValueError(
                f"{what}: proposal/rejuvenation require auto_batch=True (the "
                "guided weights and regenerative moves are derived from the "
                "per-particle kernel)")
        return kernel, None
    from modppl_tpu_torch.modeling.autobatch import (
        AutoBatchedPropose,
        auto_batch_scan_kernel,
    )

    return (auto_batch_scan_kernel(kernel),
            None if proposal is None else AutoBatchedPropose(proposal))


def num_steps(step_constraints, replay=None):
    """T - 1, from the stacked step constraints; checks a replay's length."""
    values = step_constraints.values()
    if not values:
        raise ValueError("step_constraints: no per-step values to scan over")
    steps = values[0].shape[0]
    if replay is not None and len(replay) != steps + 1:
        raise ValueError(f"replay: expected {steps + 1} entries, got "
                         f"{len(replay)}")
    return steps


def batched_particle_filter(key, kernel, state0, init_constraints,
                            step_constraints, num_particles,
                            resampling="systematic", ess_threshold=1.0,
                            auto_batch=False, proposal=None,
                            proposal_params=None, rejuvenation=None,
                            replay=None, record=None, device=None):
    """The batched-tier particle filter, on the card unless ``device`` names
    another (``device="cpu"``); ``state0``, the constraints and
    ``proposal_params`` are moved there.

    ``key`` is an integer PRNG key (core/keys.py). With ``auto_batch`` the
    ``kernel`` and ``proposal`` are ordinary per-particle Gens, wrapped by
    ``modeling/autobatch``; without it the kernel is batch-aware (``plate``
    sites, per-particle weights) and takes no proposal or rejuvenation.
    ``step_constraints`` is a Trie whose values are stacked over the T-1
    steps on their leading axis. ``resampling`` names a scheme of
    ``RESAMPLERS``; a step resamples when ESS < ``ess_threshold`` * N.
    ``proposal`` takes ``(t, state, constraints_t[, proposal_params])``;
    ``rejuvenation`` is ``(Selection, num_moves)``. ``replay`` / ``record``:
    see the module docstring.

    Returns a dict: ``state``, ``log_weights``, ``log_ml``, ``ancestors``
    ((T-1, N) int32), ``ess`` and ``resampled`` ((T-1,) each) and
    ``acceptance`` ((T-1, num_moves) mean accept of each move, None without
    rejuvenation), all on the device.
    """
    device = entry_device(device, "batched_particle_filter")
    kernel, proposal = wrap_kernel(kernel, proposal, rejuvenation,
                                   auto_batch, "batched_particle_filter")
    if resampling not in RESAMPLERS:
        raise ValueError(f"resampling: expected one of {sorted(RESAMPLERS)}, "
                         f"got {resampling!r}")
    resampler = RESAMPLERS[resampling]
    state0, init_constraints, step_constraints, proposal_params = to_device(
        (state0, init_constraints, step_constraints, proposal_params),
        device, trie_tensors=True)
    steps = num_steps(step_constraints, replay)
    s, trace = batched_smc_init(key, kernel, state0, init_constraints,
                                num_particles,
                                pool=replay[0][1] if replay else None)
    if record is not None:
        record.append((None, generated_draws(trace, init_constraints)))
    parents, ess, resampled, acceptance = [], [], [], []
    for i in range(steps):
        cons_t = step_constraints.map(lambda v: v[i])
        s, (p, e, r, a) = batched_smc_step(
            s, kernel, cons_t, num_particles, resampler, ess_threshold,
            proposal=proposal, proposal_params=proposal_params,
            rejuvenation=rejuvenation,
            replay=replay[i + 1] if replay else None, record=record)
        parents.append(p)
        ess.append(e)
        resampled.append(r)
        acceptance.append(a)
    log_ml = (s.log_ml + logsumexp(s.log_weights)
              - math.log(float(num_particles)))
    return {"state": s.state, "log_weights": s.log_weights, "log_ml": log_ml,
            "ancestors": torch.stack(parents), "ess": torch.stack(ess),
            "resampled": torch.stack(resampled),
            "acceptance": (torch.stack(acceptance)
                           if rejuvenation is not None else None)}


# --------------------------------------------------------------------------
# The vmapped tier: one key stream a particle
# --------------------------------------------------------------------------

def smc_init(key, kernel, state0, constraints, num_particles, pool=None,
             offset=0):
    """Initialize N particles: ONE generate of ``kernel.init`` over args
    ``(state0,)`` with the N lane keys ``split(k_sim, N)``, the
    reference's vmapped ``init.generate`` (a shard's ``num_particles``
    from the global index ``offset``). ``pool`` replaces the draws of the
    addresses it holds. Returns (state, the batched init trace)."""
    k_sim, k_carry = split(key)
    dtype, device = infer_dtype_device((state0,))
    keys = split_keys(k_sim, num_particles, device, offset=offset)
    trace, log_weights = kernel.init.generate(keys, (state0,), constraints,
                                              pool=pool)
    log_ml = torch.zeros((), dtype=dtype, device=device)
    log_weights = _per_particle(log_weights, num_particles, dtype, device)
    return SMCState(k_carry, trace.retv, log_weights, log_ml, 1), trace


def _rejuvenate_lanes(key, trace, kernel, selection, num_moves, moves=None,
                      record=None):
    """The reference's ``_rejuvenate``: ``num_moves`` regenerative-MH moves
    of every particle over ``selection``, particle i keyed ``split(key,
    N)[i]``, move r ``fold_in(k_i, r)`` split into the regenerate's key and
    the accept uniform's. ``moves`` replays ``(pool, accept_u)`` a move;
    ``record`` receives them. Returns (trace, the accept flags of each
    move)."""
    missing = [a for a in selection.leaf_addresses()
               if trace.data.search(a) is None]
    if missing:
        raise ValueError(
            f"rejuvenation: selection addresses {missing} not in the step "
            f"kernel's trace (has {trace.data.addresses()})")
    n = trace.logjp.shape[0]
    keys = split_keys(key, n, trace.logjp.device)
    accepts = []
    for r in range(num_moves):
        pool, u = moves[r] if moves else (None, None)
        k_regen, k_acc = split_lanes(fold_in_lanes(keys, r), 2).unbind(-1)
        new, w = kernel.step.regenerate(k_regen, trace, trace.args,
                                        ArgDiff.NO_CHANGE, selection,
                                        pool=pool)
        w = _per_particle(w, n, trace.logjp.dtype, trace.logjp.device)
        if u is None:
            u = uniform_lanes(k_acc, (), w.dtype)
        accept = torch.log(u) < w
        if record is not None:
            record.append(({a: new.data[a]
                            for a in selection.leaf_addresses()}, u))
        trace = tree_select(accept, new, trace)
        accepts.append(accept)
    return trace, accepts


def smc_step(s, kernel, constraints_t, num_particles, resampler,
             ess_threshold, store_traces=True, rejuvenation=None,
             proposal=None, proposal_params=None, replay=None, record=None):
    """One step of the vmapped filter: (maybe) resample, extend every
    particle with ONE generate of ``kernel.step`` over the N lane keys
    ``split(k_gen, N)``, optionally guided by ``proposal`` (particle i's
    lane split into the proposal's key and the model's) and rejuvenated.
    The key splits four ways, as the reference's does. ``replay`` / ``record``
    as ``batched_smc_step``'s. Returns (state, (trace or None, parents,
    ess, resampled, acceptance))."""
    n = num_particles
    key, k_res, k_gen, k_rej = split(s.key, 4)
    u, pool, proposal_pool, moves = replay_entry(replay)
    s, parents, ess, resampled, u = _resample(
        k_res, s, resampler, ess_threshold, n, u=u)
    keys = split_keys(k_gen, n, s.log_weights.device)
    trace, w, proposed = extend_lanes(
        kernel, keys, s.t, s.state, constraints_t, proposal, proposal_params,
        pool=pool, proposal_pool=proposal_pool)
    w = _per_particle(w, n, s.log_weights.dtype, s.log_weights.device)
    moved = [] if record is not None else None
    if record is not None:
        drawn = generated_draws(trace, constraints_t.addresses()
                                + list(proposed or ()))
        record.append((u, drawn) if proposal is None and rejuvenation is None
                      else (u, drawn, proposed, moved))
    acceptance = None
    if rejuvenation is not None:
        selection, num_moves = rejuvenation
        trace, accepts = _rejuvenate_lanes(k_rej, trace, kernel, selection,
                                           num_moves, moves=moves,
                                           record=moved)
        acceptance = torch.stack(accepts).to(w.dtype).mean(dim=1)
    new = SMCState(key, trace.retv, s.log_weights + w, s.log_ml, s.t + 1)
    return new, (trace if store_traces else None, parents, ess, resampled,
                 acceptance)


def _stack_tries(tries):
    """One Trie whose values and log-probabilities are the given Tries'
    stacked on a new leading axis."""
    first = tries[0]
    out = Trie()
    out.dist = first.dist
    if first.has_inner():
        out.value = torch.stack([torch.as_tensor(t.value) for t in tries])
    out.logp = (torch.stack([torch.as_tensor(t.logp) for t in tries])
                if any(torch.is_tensor(t.logp) for t in tries) else first.logp)
    out.children = {k: _stack_tries([t.children[k] for t in tries])
                    for k in first.children}
    return out


def _stack_traces(traces):
    """The per-step batched traces as one Trace with a leading time axis
    (the reference's scanned ``step_traces``)."""
    return Trace(None, _stack_tries([t.data for t in traces]),
                 pytree.tree_map(lambda *xs: torch.stack(xs),
                                 *[t.retv for t in traces]),
                 torch.stack([t.logjp for t in traces]))


def particle_filter(key, kernel, state0, init_constraints, step_constraints,
                    num_particles, resampling="systematic", ess_threshold=1.0,
                    store_traces=True, rejuvenation=None, proposal=None,
                    proposal_params=None, replay=None, record=None,
                    device=None):
    """The vmapped particle filter (the reference's ``particle_filter``), on
    the card unless ``device`` names another (``device="cpu"``);
    ``state0``, the constraints and ``proposal_params`` are moved there.

    ``kernel`` is a per-particle ScanKernel; each step's kernel body runs
    once over the particle axis with one key stream a particle.
    ``step_constraints`` holds the T-1 steps' values stacked on their
    leading axis. ``resampling`` names a scheme of ``RESAMPLERS``; a step
    resamples when ESS < ``ess_threshold`` * N (systematic resampling of a
    float32 state takes kernel 3 alone, of an int32 state S ->
    ``grid_rank``).
    ``proposal`` takes ``(t, state, constraints_t[, proposal_params])``;
    ``rejuvenation`` is ``(Selection, num_moves)``. ``replay`` / ``record``
    carry every draw, as ``batched_particle_filter``'s.

    Returns a dict: ``state``, ``log_weights``, ``log_ml``, ``ancestors``
    ((T-1, N) int32), ``ess`` and ``resampled`` ((T-1,) each),
    ``init_traces``, ``step_traces`` (the steps' traces stacked on a
    leading time axis; None without ``store_traces``) and ``acceptance``
    ((T-1, num_moves); None without rejuvenation). Nothing is read back to
    the host.
    """
    device = entry_device(device, "particle_filter")
    if resampling not in RESAMPLERS:
        raise ValueError(f"resampling: expected one of {sorted(RESAMPLERS)}, "
                         f"got {resampling!r}")
    resampler = RESAMPLERS[resampling]
    state0, init_constraints, step_constraints, proposal_params = to_device(
        (state0, init_constraints, step_constraints, proposal_params), device,
        trie_tensors=True)
    steps = num_steps(step_constraints, replay)
    s, init_traces = smc_init(key, kernel, state0, init_constraints,
                              num_particles,
                              pool=replay[0][1] if replay else None)
    if record is not None:
        record.append((None, generated_draws(init_traces, init_constraints)))
    traces, parents, ess, resampled, acceptance = [], [], [], [], []
    for i in range(steps):
        cons_t = step_constraints.map(lambda v: v[i])
        s, (tr, p, e, r, a) = smc_step(
            s, kernel, cons_t, num_particles, resampler, ess_threshold,
            store_traces=store_traces, rejuvenation=rejuvenation,
            proposal=proposal, proposal_params=proposal_params,
            replay=replay[i + 1] if replay else None, record=record)
        traces.append(tr)
        parents.append(p)
        ess.append(e)
        resampled.append(r)
        acceptance.append(a)
    log_ml = (s.log_ml + logsumexp(s.log_weights)
              - math.log(float(num_particles)))
    return {"state": s.state, "log_weights": s.log_weights, "log_ml": log_ml,
            "ancestors": torch.stack(parents), "ess": torch.stack(ess),
            "resampled": torch.stack(resampled),
            "init_traces": init_traces,
            "step_traces": _stack_traces(traces) if store_traces else None,
            "acceptance": (torch.stack(acceptance)
                           if rejuvenation is not None else None)}
