"""Checkpointed inference drivers: resumable long SMC and HMC runs
(counterpart of modppl_tpu/inference/checkpointed.py).

Each driver runs its steps on the host in chunks of ``checkpoint_every``
and saves the carry after every chunk (utils/checkpoint.py); the same path
is overwritten, so the checkpoint is the most recent resumable state. A
run resumed from a checkpoint with the same configuration and the full
constraints replays the remaining steps of the uninterrupted run bit for
bit: every step draws only from keys in the saved carry (the filters'
``s.key``) or keyed by the sample's index (the HMC runner), never from a
stream that the chunking could shift.
"""

import math

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import fold_in, split
from modppl_tpu_torch.inference import vsmc
from modppl_tpu_torch.inference.hmc import _lane_draws, start_points
from modppl_tpu_torch.modeling.handlers import (
    entry_device,
    entry_inputs,
    to_device,
)
from modppl_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from modppl_tpu_torch.utils.numerics import logsumexp


def _run_chunks(s, step, total, checkpoint_path, checkpoint_every,
                save=None):
    """Steps ``s.t - 1`` .. ``total - 1`` of ``step(s, i) -> s``, saving
    ``s`` after every ``checkpoint_every`` of them (by ``save(path, s,
    step=)``, ``save_checkpoint`` by default)."""
    save = save_checkpoint if save is None else save
    done = s.t - 1
    while done < total:
        k = min(checkpoint_every, total - done)
        for i in range(done, done + k):
            s = step(s, i)
        done += k
        save(checkpoint_path, s, step=done)
    return s


def _start(s, resume_from):
    """The initial carry ``s``, or the one restored from ``resume_from``
    into its structure (and onto its devices)."""
    if resume_from is None:
        return s
    restored, meta = restore_checkpoint(resume_from, s)
    if int(meta["step"]) != restored.t - 1:
        raise ValueError(f"checkpoint at {resume_from}: step {meta['step']} "
                         f"but its carry is at t = {restored.t}")
    return restored


# --------------------------------------------------------------------------
# SMC: the vmapped filter, chunked
# --------------------------------------------------------------------------

def checkpointed_particle_filter(key, kernel, state0, init_constraints,
                                 step_constraints, num_particles, *,
                                 checkpoint_path, checkpoint_every,
                                 resume_from=None, resampling="systematic",
                                 ess_threshold=1.0, device=None):
    """``vsmc.particle_filter(..., store_traces=False)``, with a checkpoint
    after every ``checkpoint_every`` steps, on the card unless ``device``
    names another (``device="cpu"``).

    ``checkpoint_path``: the file prefix of the checkpoint, overwritten
    each chunk. ``resume_from``: a checkpoint to restore; the filter then
    runs only the remaining steps (``step_constraints`` must be the full
    ones of the original run).

    Returns {"state", "log_weights", "log_ml", "t"}: the final particle
    system (per-step stacks are not kept; long runs are those whose
    (T, N) stacks would not fit).
    """
    device = entry_device(device, "checkpointed_particle_filter")
    if resampling not in vsmc.RESAMPLERS:
        raise ValueError(f"resampling: expected one of "
                         f"{sorted(vsmc.RESAMPLERS)}, got {resampling!r}")
    resampler = vsmc.RESAMPLERS[resampling]
    state0, init_constraints, step_constraints = to_device(
        (state0, init_constraints, step_constraints), device,
        trie_tensors=True)
    total = vsmc.num_steps(step_constraints)
    s, _ = vsmc.smc_init(key, kernel, state0, init_constraints,
                         num_particles)
    s = _start(s, resume_from)

    def step(s, i):
        s, _ = vsmc.smc_step(s, kernel, step_constraints.map(lambda v: v[i]),
                             num_particles, resampler, ess_threshold,
                             store_traces=False)
        return s

    s = _run_chunks(s, step, total, checkpoint_path, checkpoint_every)
    log_ml = (s.log_ml + logsumexp(s.log_weights)
              - math.log(float(num_particles)))
    return {"state": s.state, "log_weights": s.log_weights, "log_ml": log_ml,
            "t": s.t}


# --------------------------------------------------------------------------
# SMC: the batched-tier (sharded) filter, chunked
# --------------------------------------------------------------------------

def checkpointed_sharded_particle_filter(mesh, key, kernel, state0,
                                         init_constraints, step_constraints,
                                         num_particles, *, checkpoint_path,
                                         checkpoint_every, resume_from=None,
                                         ess_threshold=1.0, auto_batch=False,
                                         halo=None, device=None):
    """``parallel/sharded_smc.sharded_batched_particle_filter`` over the dp
    shards of ``mesh`` (None: one device), with a checkpoint after every
    ``checkpoint_every`` steps, on the card unless ``device`` names
    another. Each step is the one-shot filter's own body
    (``sharded_smc._filter_parts``), so an uninterrupted run is bitwise the
    one-shot filter's state, log-weights and log-ML, and a resumed run
    bitwise the uninterrupted one, at any dp. Kernels 1-2 launch once a
    step on the card, and kernel 3 (one shard) or kernel 4 (several).

    The checkpoint holds the whole carry in the reference's layout, the
    same file at any dp: over several shards the particles are gathered in
    shard order and rank 0 writes it (aside, then renamed into place);
    every rank restores the whole carry and keeps its own particles.

    Returns {"state", "log_weights", "log_ml", "t"}: the shard's state and
    log-weights (the mesh's ``gather`` assembles them), the replicated
    log-ML and step.
    """
    from modppl_tpu_torch.parallel import sharded_smc
    from modppl_tpu_torch.parallel.collectives import barrier

    device = sharded_smc.filter_device(mesh, device,
                                       "checkpointed_sharded_particle_filter")
    body, lse, wrapped, offset = sharded_smc._filter_parts(
        mesh, kernel, num_particles, ess_threshold, auto_batch, halo=halo)
    n_shards = 1 if mesh is None else mesh.axis("dp").size
    n_local = num_particles // n_shards
    state0, init_constraints, step_constraints = to_device(
        (state0, init_constraints, step_constraints), device,
        trie_tensors=True)
    total = vsmc.num_steps(step_constraints)

    def whole(s, fn):
        """The carry ``s`` with its per-particle leaves mapped by ``fn``."""
        return vsmc.SMCState(s.key, pytree.tree_map(fn, s.state),
                             fn(s.log_weights), s.log_ml, s.t)

    def save(path, s, step):
        if n_shards == 1:
            save_checkpoint(path, s, step=step)
            return
        s = whole(s, mesh.gather)
        if mesh.rank == mesh.devices.flat[0]:
            save_checkpoint(path, s, step=step)
        barrier("dp")

    def part(x):
        return x[offset:offset + n_local]

    with sharded_smc.entered(mesh):
        s, _ = vsmc.batched_smc_init(key, wrapped, state0, init_constraints,
                                     n_local, offset=offset)
        if resume_from is not None:
            # the whole carry's shapes, then this shard's part of it
            example = whole(s, lambda x: x.new_zeros(
                (num_particles,) + tuple(x.shape[1:])))
            s = whole(_start(example, resume_from), part)

        def step(s, i):
            s, _ = body(s, step_constraints.map(lambda v: v[i]))
            return s

        s = _run_chunks(s, step, total, checkpoint_path, checkpoint_every,
                        save=save)
        log_ml = (s.log_ml + lse(s.log_weights)
                  - math.log(float(num_particles)))
    return {"state": s.state, "log_weights": s.log_weights, "log_ml": log_ml,
            "t": s.t}


# --------------------------------------------------------------------------
# HMC: the pooled-adaptation sampler, chunked
# --------------------------------------------------------------------------

def checkpointed_hmc_runner(model, args, observed, *, checkpoint_path,
                            checkpoint_every, num_samples=1000,
                            num_warmup=500, num_chains=2, step_size=0.1,
                            num_leapfrog=16, target_accept=0.8,
                            selection=None, setup_key=None, device=None):
    """A resumable pooled-adaptation HMC runner on the generic path (no
    quadratic fast path, so no kernel), on the card unless ``device`` names
    another.

    Returns ``run(key, resume_from=None, draws=None, u0s=None) -> dict``
    (``hmc_runner``'s output less its fused-path fields): the warmup runs
    whole (``adaptation.run_warmup_pooled`` with a batched transition),
    then sampling runs in chunks of ``checkpoint_every`` samples, saving
    the positions, the step size, the inverse mass and the sample count
    after each. ``resume_from`` restores such a checkpoint and runs only
    the remaining samples.

    The transition is ``hmc._transition_batch``: (positions, logp, grad)
    are carried, one value-and-grad call a leapfrog step. Each chunk starts
    from the value and gradient at its restored or carried positions, so a
    resumed chunk starts as the uninterrupted run's does.

    Keys: with ``key = fold_in(k_run, 0)``, warmup iteration j of phase p
    takes ``split(fold_in(fold_in(key, 0), p), length)[j]`` and sample i
    ``fold_in(fold_in(key, 2), i)``, as the reference keys them; chain c of
    an iteration keyed k draws from the lane key ``fold_in(k, c)``
    (core/keys.py), so every chunk schedule and chain count replays the
    same chains. Start points: ``u0 + 0.5 z``, chain c's z from
    ``split(k_run, C)[c]``. ``draws`` (one (z (T, C, d), jit (T, C), u01
    (T, C)) per phase, the warmup's then sampling's, whose row i is sample
    i) and ``u0s`` (C, d) replace these draws and start points, as
    ``interop.pooled_phase_draws`` carries the reference's.
    """
    from modppl_tpu_torch.inference.adaptation import run_warmup_pooled
    from modppl_tpu_torch.inference.hmc import (
        _phase_draws,
        _phase_steps,
        _transition_batch,
        _value_and_grad,
        flat_target,
    )

    if num_chains < 2:
        raise ValueError("checkpointed_hmc_runner: pooled adaptation needs "
                         "num_chains >= 2")
    device, args, observed = entry_inputs(device, args, observed,
                                          "checkpointed_hmc_runner")
    init_trace, _ = model.generate(0 if setup_key is None else setup_key,
                                   args, observed, device=device)
    target = flat_target(model, args, init_trace, observed, selection,
                         device=device)
    # the chains run in the log-density's precision, so the carry that a
    # checkpoint saves keeps one dtype from warmup to the last sample
    dtype = torch.promote_types(target.u0.dtype,
                                torch.as_tensor(target.logprob(
                                    target.u0)).dtype)
    u0 = target.u0.to(dtype)
    dim = u0.shape[0]
    vag = _value_and_grad(target.logprob)

    def lane_draws(k):
        return _lane_draws(k, num_chains, dim, dtype, device)

    def transition(x, carry, eps, inv_mass):
        U, LP, G, aprob, div = _transition_batch(vag, *carry, eps, inv_mass,
                                                 *x, num_leapfrog)
        return (U, LP, G), aprob, div

    def warm(k_run, phases, u0s):
        if u0s is None:
            u0s = start_points(k_run, u0, num_chains)

        def inputs(phase, phase_key, length):
            if phases[phase] is None:
                return map(lane_draws, split(phase_key, length))
            return _phase_steps(phase_key, length, u0s, phases[phase])

        def warm_transition(x, carry, eps, inv_mass):
            carry, aprob, _ = transition(x, carry, eps, inv_mass)
            return carry, aprob

        carry, eps, inv_mass = run_warmup_pooled(
            fold_in(fold_in(k_run, 0), 0), u0s, warm_transition, num_warmup,
            step_size, target_accept, batched_transition=True,
            phase_inputs=inputs, carry=(u0s, *vag(u0s)))
        return carry[0], eps, inv_mass

    def run(k_run, resume_from=None, draws=None, u0s=None):
        phases = list(_phase_draws(draws, num_warmup))
        samp = phases[-1]
        if samp is not None:
            # checked whole: its rows are sample indices
            _phase_steps(None, num_samples, u0.new_zeros((num_chains, dim)),
                         samp)
        if resume_from is None:
            us, eps, inv_mass = warm(k_run, phases, u0s)
            done = 0
        else:
            example = {"us": torch.zeros((num_chains, dim), dtype=dtype,
                                         device=device),
                       "eps": torch.zeros((), dtype=dtype, device=device),
                       "inv_mass": torch.zeros(dim, dtype=dtype,
                                               device=device),
                       "done": torch.zeros((), dtype=torch.int64)}
            state, meta = restore_checkpoint(resume_from, example)
            us, eps, inv_mass = state["us"], state["eps"], state["inv_mass"]
            done = int(state["done"])
            if int(meta["step"]) != done:
                raise ValueError(f"checkpoint at {resume_from}: step "
                                 f"{meta['step']} but its carry has {done} "
                                 f"samples")
        base = fold_in(fold_in(k_run, 0), 2)
        ys = []
        while done < num_samples:
            k = min(checkpoint_every, num_samples - done)
            carry = (us, *vag(us))
            for i in range(done, done + k):
                x = (lane_draws(fold_in(base, i)) if samp is None
                     else tuple(a[i] for a in samp))
                carry, aprob, div = transition(x, carry, eps, inv_mass)
                ys.append((carry[0], carry[1], aprob, div))
            us = carry[0]
            done += k
            save_checkpoint(checkpoint_path,
                            {"us": us, "eps": eps, "inv_mass": inv_mass,
                             "done": torch.tensor(done)},
                            step=done)
        if ys:
            uss, logps, aprobs, divs = (torch.stack(x, 1) for x in zip(*ys))
        else:
            uss = us.new_zeros((num_chains, 0, dim))
            logps = aprobs = us.new_zeros((num_chains, 0))
            divs = torch.zeros((num_chains, 0), dtype=torch.bool,
                               device=device)
        return {"samples": target.constrain(uss), "logp": logps,
                "accept_prob": aprobs, "divergences": divs,
                "step_size": eps, "inv_mass": inv_mass,
                "unconstrained": uss}

    return run
