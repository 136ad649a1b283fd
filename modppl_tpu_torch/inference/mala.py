"""Metropolis-adjusted Langevin algorithm (MALA) with dual-averaging step
size adaptation (counterpart of modppl_tpu/inference/mala.py).

One gradient per proposal, with the asymmetric-drift MH correction, on the
unconstrained log-joint HMC uses (inference/hmc.make_unconstrained_logprob).
The reference vmaps one chain's scan over the chains; the port runs the
whole batch at once, as ``adaptation.run_warmup`` does for HMC: each step
is ONE ``vmap(grad_and_value)`` call over the chains, and every chain keeps
its own dual-averaging state (leaves of shape (chains,)). Nothing is read
back to the host per transition. Each chain draws from its own lane stream
keyed by its index (``inference/hmc._lane_draws``), so chain i's draws do
not depend on the chain count.

Proposal: u' = u + (eps^2 / 2) grad(u) + eps * xi,  xi ~ N(0, I)
Accept:   log u01 < logp(u') - logp(u) + log q(u | u') - log q(u' | u)
"""

import torch

from modppl_tpu_torch.core.keys import fold_in, split
from modppl_tpu_torch.inference.hmc import (
    _lane_draws,
    _segments,
    _value_and_grad,
    da_init,
    da_update,
    flat_target,
    start_points,
)
from modppl_tpu_torch.modeling.handlers import entry_inputs


def _mala_step(u, logp_val, grad_val, vag, eps, noise, u01):
    """One transition of a chain (u (d,), eps scalar) or a batch (u (C, d),
    eps (C,)) on given draws: noise like u, u01 one a chain. ``vag(u) ->
    (logp, grad)``. Returns (u', logp', grad', accept_prob)."""
    e = eps[..., None] if torch.is_tensor(eps) and eps.ndim else eps
    drift = 0.5 * e * e * grad_val
    u_new = u + drift + e * noise
    logp_new, grad_new = vag(u_new)
    # log q(u | u') - log q(u' | u), Gaussians with drifted means
    fwd = u_new - u - drift
    bwd = u - u_new - 0.5 * e * e * grad_new
    log_q_diff = (torch.sum(fwd * fwd, -1)
                  - torch.sum(bwd * bwd, -1)) / (2.0 * eps * eps)
    log_alpha = logp_new - logp_val + log_q_diff
    accept_prob = torch.clamp(torch.exp(torch.clamp(log_alpha, max=0.0)),
                              max=1.0)
    accept = (torch.log(u01) < log_alpha) & torch.isfinite(logp_new)
    return (torch.where(accept[..., None], u_new, u),
            torch.where(accept, logp_new, logp_val),
            torch.where(accept[..., None], grad_new, grad_val), accept_prob)


def mala_transition(key, u, logp_val, grad_val, logp_fn, grad_fn, eps,
                    draws=None):
    """One MALA transition on flat coordinates, for one chain (u (d,)) or
    a batch (u (C, d), eps (C,) or scalar; ``logp_fn`` and ``grad_fn`` take
    what ``u`` is).

    Carries (logp, grad) of the current point, so a transition costs one
    fresh gradient. The draws come from the chains' lane streams keyed
    ``key`` (chain i's from ``fold_in(key, i)``, one chain is chain 0):
    standard normals like u and one uniform a chain; ``draws`` = (noise,
    u01) replaces them. Returns (u', logp', grad', accept_prob).
    """
    if draws is None:
        one = u.ndim == 1
        draws = _lane_draws(key, 1 if one else u.shape[0], u.shape[-1],
                            u.dtype, u.device, jitter=False)
        if one:
            draws = tuple(x[0] for x in draws)
    return _mala_step(u, logp_val, grad_val,
                      lambda x: (logp_fn(x), grad_fn(x)), eps, *draws)


def _phase_draws(phase_key, length, u0s, draws=None):
    """A phase's per-iteration (noise (C, d), u01 (C,)): the rows of
    ``draws`` = (noise (T, C, d), u01 (T, C)) when given, else segments
    (``hmc._segments``), segment ``seg`` keyed ``fold_in(phase_key,
    seg)``, chain i from its lane stream (``hmc._lane_draws``)."""
    if draws is not None:
        if tuple(draws[0].shape) != (length,) + tuple(u0s.shape):
            raise ValueError(f"draws: noise of shape "
                             f"{(length,) + tuple(u0s.shape)} expected, got "
                             f"{tuple(draws[0].shape)}")
        yield from zip(*draws)
        return

    def draw(seg_key, w):
        return _lane_draws(seg_key, u0s.shape[0], u0s.shape[1], u0s.dtype,
                           u0s.device, length=w, jitter=False)

    yield from _segments(phase_key, length, draw)


def _chains(key, logprob, u0s, num_warmup, num_samples, eps0,
            target_accept, draws=None):
    """Every chain of ``u0s`` (C, d) adapts its own step size by dual
    averaging over ``num_warmup`` transitions, then samples at
    exp(log_eps_bar): the reference's ``vmap(_single_chain)`` as one batch.
    Phase keys: warmup ``fold_in(key, 0)``, sampling ``fold_in(key, 1)``;
    ``draws`` = (warmup (noise, u01), sampling (noise, u01)) replaces them.
    Returns (us (C, S, d), logps (C, S), aprobs (C, S), eps (C,))."""
    vag = _value_and_grad(logprob)
    warm, samp = draws if draws is not None else (None, None)
    u, (lp, g) = u0s, vag(u0s)
    da = da_init(u0s.new_full(u0s.shape[:1], float(eps0)))
    for noise, u01 in _phase_draws(fold_in(key, 0), num_warmup, u0s, warm):
        u, lp, g, aprob = _mala_step(u, lp, g, vag, torch.exp(da["log_eps"]),
                                     noise, u01)
        da = da_update(da, aprob, target=target_accept)
    eps = torch.exp(da["log_eps_bar"])
    ys = []
    for noise, u01 in _phase_draws(fold_in(key, 1), num_samples, u0s, samp):
        u, lp, g, aprob = _mala_step(u, lp, g, vag, eps, noise, u01)
        ys.append((u, lp, aprob))
    us, logps, aprobs = (torch.stack(x, 1) for x in zip(*ys))
    return us, logps, aprobs, eps


def mala(key, model, args, observed, *, num_samples=1000, num_warmup=500,
         num_chains=1, step_size=0.1, target_accept=0.574, selection=None,
         init_trace=None, device=None):
    """Run adaptive MALA; returns samples in constrained space and
    diagnostics, as ``hmc``: ``samples`` ({addr: (chains, num_samples) +
    shape}), ``logp``, ``accept_prob``, ``step_size`` (chains,) and
    ``unconstrained``. 0.574 is the optimal-scaling acceptance target for
    Langevin proposals (Roberts & Rosenthal 1998). Chains start at the
    initial trace's values plus 0.5 standard normals, chain i's keyed
    ``split(k_chains, C)[i]``. Runs on ``device``:
    the card unless the caller passes ``device="cpu"``."""
    device, args, observed = entry_inputs(device, args, observed, "mala")
    k_init, k_run = split(key)
    if init_trace is None:
        init_trace, _ = model.generate(k_init, args, observed,
                                       device=device)
    target = flat_target(model, args, init_trace, observed, selection,
                         device=device)
    k_chains, k_steps = split(k_run)
    u0s = start_points(k_chains, target.u0, num_chains)
    us, logps, aprobs, eps = _chains(k_steps, target.logprob, u0s,
                                     num_warmup, num_samples, step_size,
                                     target_accept)
    return {"samples": target.constrain(us), "logp": logps,
            "accept_prob": aprobs, "step_size": eps, "unconstrained": us}
