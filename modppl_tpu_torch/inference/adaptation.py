"""Warmup adaptation: dual-averaging step size and windowed diagonal mass
estimation (counterpart of modppl_tpu/inference/adaptation.py).

Stan's schedule, shared by every HMC path:

  [ fast: step size only | slow windows: 25, 50, 100, ... (mass) | fast ]

Each slow window estimates the variance of the unconstrained draws; at its
end the diagonal inverse mass becomes the regularized variance and dual
averaging restarts around the current step size.

Two tiers:

- :func:`run_warmup`: every chain adapts its own (step size, inverse
  mass) from its own history. The reference vmaps one chain's warmup over
  the chains; here the whole batch runs as one, each chain's dual-averaging
  leaves (C,) and Welford sums (C, d).
- :func:`run_warmup_pooled`: one shared (step size, inverse mass), adapted
  from the accept statistics and draws of all chains.

The pooled sums can cross shards (``axis_name``, a mesh axis of
parallel/mesh.py, one process a shard): each shard's tree-partial is
all-gathered in shard order and the partials summed by the same tree on
every shard, as the reference's ``_pooled_sum`` does, so the adapted
(step size, inverse mass) are bitwise the same at any power-of-two layout.
"""

import torch

from modppl_tpu_torch.core.keys import fold_in, split
from modppl_tpu_torch.inference.hmc import da_init, da_update


def warmup_schedule(num_warmup, init_buffer=None, term_buffer=None,
                    base_window=25):
    """Return (fast1, [slow window sizes], fast2) summing to num_warmup:
    Stan's windowed schedule (step size only, doubling mass windows, step
    size only)."""
    if num_warmup < 20:
        return num_warmup, [], 0
    fast1 = init_buffer if init_buffer is not None \
        else max(num_warmup * 15 // 100, 10)
    fast2 = term_buffer if term_buffer is not None \
        else max(num_warmup * 10 // 100, 10)
    slow_total = num_warmup - fast1 - fast2
    if slow_total <= 0:
        return num_warmup, [], 0
    windows = []
    w = base_window
    remaining = slow_total
    while remaining > 0:
        if remaining < 2 * w or remaining < base_window:
            windows.append(remaining)
            remaining = 0
        else:
            windows.append(w)
            remaining -= w
            w *= 2
    return fast1, windows, fast2


def slow_windows(num_warmup):
    """The slow (mass-adapting) windows of ``warmup_schedule`` as
    ``(start, end)`` iteration ranges. A window's metric update and
    dual-averaging restart fire just before iteration ``end``, as in the
    reference's chunk kernels."""
    fast1, slow, _ = warmup_schedule(num_warmup)
    out, start = [], fast1
    for w in slow:
        out.append((start, start + w))
        start += w
    return out


def warmup_phases(num_warmup):
    """The phases of ``warmup_schedule`` in order, empty ones left out:
    (length, slow) each, ``slow`` True for a mass-adapting window."""
    fast1, slow, fast2 = warmup_schedule(num_warmup)
    return [(n, is_slow) for n, is_slow in
            [(fast1, False), *((w, True) for w in slow), (fast2, False)]
            if n > 0]


def _window_metric(m2, n):
    """The diagonal inverse mass at a slow window's end from its Welford
    sums: the variance, shrunk toward 1e-3 by n / (n + 5) as Stan does, and
    clipped to [1e-8, 1e8]. inv_mass is M^-1 in the transition (momenta
    z / sqrt(inv_mass), u += eps inv_mass p), so the variance, not its
    inverse, preconditions the target."""
    var = m2 / torch.clamp(n - 1.0, min=1.0)
    shrink = n / (n + 5.0)
    var = shrink * var + (1.0 - shrink) * 1e-3
    return torch.clamp(var, 1e-8, 1e8)


def _phase_keys(phase, phase_key, length):
    """A phase's per-iteration keys, as the reference splits them."""
    return split(phase_key, length)


def run_warmup(key, u0s, transition, num_warmup, eps0, target_accept=0.8,
               phase_inputs=_phase_keys):
    """Adapt each chain's own (step size, diagonal inverse mass).

    ``transition(x, us, eps, inv_mass) -> (us, accept_probs)`` moves the
    whole batch: us (C, d), eps (C,), inv_mass (C, d), accept_probs (C,).
    ``x`` is the iteration's input: the ``length`` inputs of the phase
    numbered ``phase`` are ``phase_inputs(phase, fold_in(key, phase),
    length)``, by default the phase's keys ``split(phase_key, length)``, as
    the reference keys a chain's iterations. Returns (us (C, d), eps (C,),
    inv_mass (C, d)).
    """
    zeros = torch.zeros_like(u0s)
    inv_mass = torch.ones_like(u0s)

    def run_phase(phase, us, da, inv_mass, length, adapt_mass):
        mean, m2, n = zeros, zeros, u0s.new_zeros(())
        for x in phase_inputs(phase, fold_in(key, phase), length):
            eps = torch.exp(da["log_eps"])
            us, aprob = transition(x, us, eps, inv_mass)
            da = da_update(da, aprob, target=target_accept)
            if adapt_mass:
                n = n + 1.0
                delta = us - mean
                mean = mean + delta / n
                m2 = m2 + delta * (us - mean)
        return us, da, m2, n

    us = u0s
    da = da_init(u0s.new_full(u0s.shape[:1], float(eps0)))
    for phase, (length, slow) in enumerate(warmup_phases(num_warmup)):
        us, da, m2, n = run_phase(phase, us, da, inv_mass, length, slow)
        if slow:
            inv_mass = _window_metric(m2, n)
            # restart dual averaging around the current adapted step size
            da = da_init(torch.exp(da["log_eps_bar"]))
    return us, torch.exp(da["log_eps_bar"]), inv_mass


# --------------------------------------------------------------------------
# Pooled (cross-chain) adaptation
# --------------------------------------------------------------------------

def _tree_sum(x):
    """Sum over the leading axis by an explicit ADJACENT-pairing add tree:
    (x[0]+x[1]), (x[2]+x[3]), ... per level, odd extents zero-padded to a
    power of two. The same association as the reference, so the result is
    bitwise the reference's on the same input."""
    n = x.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while p > 1:
        p //= 2
        x = x[0::2] + x[1::2]
    return x[0]


def _pooled_sum(x, axis_name=None):
    """Sum ``x`` over its leading (chain) axis in a fixed order.

    One device: the adjacent-pairing tree of :func:`_tree_sum`. Over the
    shards of ``axis_name``: the local tree-partial is all-gathered in
    shard order and the partials tree-summed on every shard alike; for
    power-of-two chains a shard and shard counts this is the same global
    tree, bitwise."""
    part = _tree_sum(x)
    if axis_name is None:
        return part
    from modppl_tpu_torch.parallel.collectives import all_gather

    return _tree_sum(all_gather(part, axis_name, tiled=False))


def pooled_chains(c_local, axis_name=None):
    """(all chains, this shard's first global chain index) of ``c_local``
    chains a shard over ``axis_name`` (None: one device)."""
    if axis_name is None:
        return c_local, 0
    from modppl_tpu_torch.parallel.collectives import axis_index, axis_size

    return c_local * axis_size(axis_name), c_local * axis_index(axis_name)


def run_warmup_pooled(key, u0s, transition, num_warmup, eps0,
                      target_accept=0.8, axis_name=None,
                      batched_transition=False, phase_inputs=_phase_keys,
                      carry=None):
    """Adapt ONE shared (step size, diagonal inverse mass) from all chains.

    ``u0s`` (C, d). With ``batched_transition=True``, ``transition(key, us,
    eps, inv_mass) -> (us, accept_probs)`` moves the whole batch with the
    iteration's key; otherwise ``transition(key, u, eps, inv_mass) -> (u,
    accept_prob)`` moves one chain, with the key ``fold_in(key, i)`` for
    chain i, as the reference keys it. The port's keys are host integers,
    which ``torch.func.vmap`` cannot map, so a per-chain transition runs
    chain by chain; a batched transition avoids that. Each iteration's
    accept mean and the batch's (Chan) Welford update use the fixed-order
    sums of :func:`_pooled_sum`. Over the shards of ``axis_name`` ``u0s``
    is the shard's (C_local, d) chains, i its global index, and the sums
    pool every shard's chains. Returns (us (C, d), eps (), inv_mass
    (d,)).

    ``phase_inputs(phase, phase_key, length)`` gives a phase's iteration
    inputs, passed to the transition where the key would be: by default
    its keys ``split(phase_key, length)``, as the reference splits them
    (a per-chain transition needs keys). ``carry`` (a batched transition
    only) is a tuple whose first entry is ``u0s``, such as (us, logp,
    grad): the transition then takes and returns the whole tuple in place
    of ``us``, the window statistics read its first entry, and the final
    tuple is returned in place of ``us``.
    """
    if carry is not None and not batched_transition:
        raise ValueError("run_warmup_pooled: a carry needs "
                         "batched_transition=True")
    c = u0s.shape[0]
    zeros = u0s.new_zeros(u0s.shape[1:])
    inv_mass = torch.ones_like(zeros)
    c_all, c0 = pooled_chains(c, axis_name)
    c_total = u0s.new_tensor(float(c_all))

    def psum(x):
        return _pooled_sum(x, axis_name)

    def move(k, us, eps, inv_mass):
        if batched_transition:
            return transition(k, us, eps, inv_mass)
        outs = [transition(fold_in(k, c0 + i), us[i], eps, inv_mass)
                for i in range(c)]
        return (torch.stack([u for u, _ in outs]),
                torch.stack([torch.as_tensor(a, dtype=us.dtype,
                                             device=us.device)
                             for _, a in outs]))

    def run_phase(phase, state, da, inv_mass, length, adapt_mass):
        mean, m2, n = zeros, zeros, u0s.new_zeros(())
        for x in phase_inputs(phase, fold_in(key, phase), length):
            eps = torch.exp(da["log_eps"])
            state, aprobs = move(x, state, eps, inv_mass)
            us = state if carry is None else state[0]
            a_mean = psum(aprobs) / c_total
            da = da_update(da, a_mean, target=target_accept)
            if adapt_mass:
                # the batched (Chan) Welford update pooling the
                # iteration's C draws at once
                b_mean = psum(us) / c_total
                b_m2 = psum((us - b_mean[None]) ** 2)
                n_new = n + c_total
                delta = b_mean - mean
                mean = mean + delta * c_total / n_new
                m2 = m2 + b_m2 + delta * delta * n * c_total / n_new
                n = n_new
        return state, da, m2, n

    state = u0s if carry is None else carry
    da = da_init(u0s.new_tensor(float(eps0)))
    for phase, (length, slow) in enumerate(warmup_phases(num_warmup)):
        state, da, m2, n = run_phase(phase, state, da, inv_mass, length,
                                     slow)
        if slow:
            inv_mass = _window_metric(m2, n)
            da = da_init(torch.exp(da["log_eps_bar"]))
    return state, torch.exp(da["log_eps_bar"]), inv_mass
