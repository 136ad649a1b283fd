"""Conditional SMC and particle Gibbs with ancestor sampling (counterpart of
modppl_tpu/inference/pgibbs.py).

Particle Gibbs targets the latent trajectory of a state-space model by
iterating conditional-SMC sweeps: a particle filter in which slot 0 is
pinned to the previous sweep's trajectory, so that the sampled path is a
Gibbs update for the exact smoothing posterior. Ancestor sampling (PGAS,
Lindsten, Jordan & Schon 2014) resamples the pinned slot's ancestry each
step.

On the vmapped tier, as the reference argues (pgibbs.py:24-33): the free
particles extend with ONE generate over the N lane keys ``split(k, N)``
(core/keys.py), the pinned slot with one generate on the reference
choices, and slot 0 is overwritten out of place (``_splice0``). The
ancestors are conditional multinomial draws (the port's ``categorical``);
the ancestor-sampling score is one fully constrained generate over the
lanes under a placeholder key, which draws nothing (an address it would
draw raises). The backtracking is a reversed loop of device gathers; nothing
is read back to the host. No kernel lies on this path.
"""

import math

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import generator, split, split_keys
from modppl_tpu_torch.dists import categorical
from modppl_tpu_torch.modeling.autobatch import _per_particle
from modppl_tpu_torch.modeling.handlers import entry_device, to_device
from modppl_tpu_torch.parallel.resample import gather_particles


def _constraints_with(base, extra_dict):
    """base constraints plus {addr: value} entries, as a fresh Trie."""
    out = base.copy()
    for addr, value in extra_dict.items():
        out.observe(addr, value)
    return out


def _score_at(trace, addrs):
    """Sum of the trace's recorded logps at (and below) the given
    addresses."""
    total = 0.0
    for addr in addrs:
        total = total + trace.data.search(addr).weight()
    return total


def _splice0(batched, pinned):
    """Every leading-axis leaf of ``batched`` with slot 0 replaced by the
    pinned pytree's leaf (a new tensor; the inputs are untouched)."""
    return pytree.tree_map(
        lambda b, p: torch.cat([torch.as_tensor(p, dtype=b.dtype,
                                                device=b.device)[None],
                                b[1:]]), batched, pinned)


def _pick(key, log_weights, num=None):
    """``num`` (or one) categorical index draws from the log-weights, from
    ``key``'s stream."""
    probs = torch.softmax(log_weights, 0)
    g = generator(key, log_weights.device)
    if num is None:
        return categorical.sample(g, (probs,))
    return categorical.sample_batch(g, (num,), (probs,))


def _ref_scores(kernel, t, states, full_t, n):
    """log p(ref_t | x_i) + the obs term for every particle: one fully
    constrained generate over the lanes under a placeholder key. A latent
    the reference does not constrain would draw, so it raises instead."""
    keys = torch.zeros(n, dtype=torch.int64,
                       device=pytree.tree_leaves(states)[0].device)
    trace, w = kernel.step.generate(keys, (t, states), full_t)
    drew = [a for a in trace.data.addresses() if a not in full_t]
    if drew:
        raise ValueError(f"csmc_sweep: ancestor sampling needs every latent "
                         f"of the step constrained by the reference; "
                         f"{drew} would draw")
    return w


def _backtrack(j_final, choices_steps, parents_steps):
    """The trajectory that ends at particle ``j_final``: for each step, from
    the last back, its choices at j, then j = that step's parent of j.
    Returns (the init slot j0, {addr: (T-1,) + shape})."""
    j = j_final.reshape(1).long()
    picked = []
    for choices_t, parents_t in zip(reversed(choices_steps),
                                    reversed(parents_steps)):
        picked.append({a: torch.index_select(v, 0, j)[0]
                       for a, v in choices_t.items()})
        j = torch.index_select(parents_t, 0, j).long()
    picked.reverse()
    addrs = picked[0].keys() if picked else ()
    return j, {a: torch.stack([p[a] for p in picked]) for a in addrs}


def csmc_sweep(key, kernel, state0, init_constraints, step_constraints,
               ref_init, ref_steps, num_particles, ancestor_sampling=True,
               device=None):
    """One conditional-SMC sweep, on the card unless ``device`` names
    another; returns a freshly sampled trajectory.

    ``ref_init`` maps the init model's latent addresses to the reference
    trajectory's values, ``ref_steps`` the step model's to (T-1,) + shape
    values. Slot 0 carries the reference. ``ancestor_sampling`` draws the
    pinned slot's ancestor from w_i p(ref_t | x_i) (PGAS); False pins it to
    slot 0.

    Returns {"ref_init", "ref_steps" (the new trajectory, as the inputs),
    "log_ml" (the sweep's estimate)}.
    """
    device = entry_device(device, "csmc_sweep")
    state0, init_constraints, step_constraints, ref_init, ref_steps = \
        to_device((state0, init_constraints, step_constraints, ref_init,
                   ref_steps), device, trie_tensors=True)
    n = num_particles
    latent_init_addrs = tuple(sorted(ref_init))
    latent_step_addrs = tuple(sorted(ref_steps))
    obs_init_addrs = tuple(init_constraints.addresses())
    obs_step_addrs = tuple(step_constraints.addresses())
    k_init_free, k_init_pin, k_scan, k_pick = split(key, 4)

    # t = 0: free particles + the pinned slot 0
    traces, log_w = kernel.init.generate(split_keys(k_init_free, n, device),
                                         (state0,), init_constraints)
    pinned, _ = kernel.init.generate(
        k_init_pin, (state0,), _constraints_with(init_constraints, ref_init),
        device=device)
    dtype = traces.logjp.dtype
    log_w = _splice0(_per_particle(log_w, n, dtype, device),
                     _score_at(pinned, obs_init_addrs))
    states = _splice0(traces.retv, pinned.retv)
    choices0 = {a: _splice0(traces.data[a], pinned.data[a])
                for a in latent_init_addrs}

    log_ml = torch.zeros((), dtype=dtype, device=device)
    key = k_scan
    choices_steps, parents_steps = [], []
    for i in range(step_constraints.values()[0].shape[0]):
        t = i + 1
        cons_t = step_constraints.map(lambda v: v[i])
        ref_t = {a: v[i] for a, v in ref_steps.items()}
        key, k_res, k_anc, k_gen, k_pin = split(key, 5)

        # resample (always): conditional multinomial, slot 0 pinned
        log_total = torch.logsumexp(log_w, 0)
        log_norm = log_w - log_total
        log_ml = log_ml + log_total - math.log(float(n))
        parents = _pick(k_res, log_norm, n)
        full_t = _constraints_with(cons_t, ref_t)
        if ancestor_sampling:
            parent0 = _pick(k_anc, log_norm + _ref_scores(
                kernel, t, states, full_t, n))
        else:
            parent0 = torch.zeros((), dtype=parents.dtype, device=device)
        parents = _splice0(parents, parent0)
        states = gather_particles(states, parents)

        # extend: the free particles, and slot 0 on the reference choices
        traces, log_w = kernel.step.generate(split_keys(k_gen, n, device),
                                             (t, states), cons_t)
        state0_t = pytree.tree_map(lambda s: s[0], states)
        pinned, _ = kernel.step.generate(k_pin, (t, state0_t), full_t,
                                         device=device)
        log_w = _splice0(_per_particle(log_w, n, dtype, device),
                         _score_at(pinned, obs_step_addrs))
        states = _splice0(traces.retv, pinned.retv)
        choices_steps.append({a: _splice0(traces.data[a], pinned.data[a])
                              for a in latent_step_addrs})
        parents_steps.append(parents)
    log_total = torch.logsumexp(log_w, 0)
    log_ml = log_ml + log_total - math.log(float(n))

    # sample a trajectory and backtrack its ancestry
    j_final = _pick(k_pick, log_w - log_total)
    j0, new_ref_steps = _backtrack(j_final, choices_steps, parents_steps)
    new_ref_init = {a: torch.index_select(v, 0, j0)[0]
                    for a, v in choices0.items()}
    return {"ref_init": new_ref_init, "ref_steps": new_ref_steps,
            "log_ml": log_ml}


def _prior_reference(key, kernel, state0, init_constraints, step_constraints,
                     latent_init_addrs, latent_step_addrs, device=None):
    """A single bootstrap path from the prior to seed the first sweep."""
    k0, key = split(key)
    tr0, _ = kernel.init.generate(k0, (state0,), init_constraints,
                                  device=device)
    ref_init = {a: tr0.data.read(a) for a in latent_init_addrs}
    state, steps = tr0.retv, []
    for i in range(step_constraints.values()[0].shape[0]):
        key, k = split(key)
        tr, _ = kernel.step.generate(k, (i + 1, state),
                                     step_constraints.map(lambda v: v[i]),
                                     device=device)
        state = tr.retv
        steps.append({a: tr.data.read(a) for a in latent_step_addrs})
    return ref_init, {a: torch.stack([s[a] for s in steps])
                      for a in latent_step_addrs}


def particle_gibbs(key, kernel, state0, init_constraints, step_constraints,
                   *, latent_init_addrs, latent_step_addrs,
                   num_particles=64, num_sweeps=200, ancestor_sampling=True,
                   device=None):
    """Particle Gibbs: ``num_sweeps`` CSMC sweeps, each conditioned on the
    last one's trajectory, on the card unless ``device`` names another.
    Targets the exact smoothing posterior p(x_{0:T-1} | y_{0:T-1}).

    ``latent_init_addrs`` / ``latent_step_addrs`` name the latent addresses
    of the init / step functions. Returns {"init": {addr: (num_sweeps,) +
    shape}, "steps": {addr: (num_sweeps, T-1) + shape}, "log_ml":
    (num_sweeps,)}, one sampled trajectory a sweep.
    """
    device = entry_device(device, "particle_gibbs")
    state0, init_constraints, step_constraints = to_device(
        (state0, init_constraints, step_constraints), device,
        trie_tensors=True)
    k_seed, k_sweeps = split(key)
    ref_init, ref_steps = _prior_reference(
        k_seed, kernel, state0, init_constraints, step_constraints,
        latent_init_addrs, latent_step_addrs, device=device)
    inits, steps, log_mls = [], [], []
    for k in split(k_sweeps, num_sweeps):
        out = csmc_sweep(k, kernel, state0, init_constraints,
                         step_constraints, ref_init, ref_steps,
                         num_particles, ancestor_sampling=ancestor_sampling,
                         device=device)
        ref_init, ref_steps = out["ref_init"], out["ref_steps"]
        inits.append(ref_init)
        steps.append(ref_steps)
        log_mls.append(out["log_ml"])
    return {"init": {a: torch.stack([r[a] for r in inits])
                     for a in latent_init_addrs},
            "steps": {a: torch.stack([r[a] for r in steps])
                      for a in latent_step_addrs},
            "log_ml": torch.stack(log_mls)}
