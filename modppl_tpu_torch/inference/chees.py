"""ChEES-HMC: jittered fixed-length trajectories with pooled adaptation
(counterpart of modppl_tpu/inference/chees.py).

ChEES (Hoffman, Radul & Sountsov, AISTATS 2021) replaces NUTS's per-chain
U-turn criterion with ONE trajectory length shared by every chain, adapted
from cross-chain statistics:

- iteration t runs ``L_t = ceil(h_t · τ / ε)`` leapfrog steps, with ``h_t``
  a shared Halton-sequence jitter in (0, 1), so all chains march in
  lockstep: each leapfrog step is ONE batched ``vmap(grad_and_value)`` call
  over the chains;
- τ maximizes the ChEES criterion E[(‖x' − E x'‖² − ‖x − E x‖²)²]/4 by Adam
  on log τ, with the gradient from accept-weighted per-chain statistics
  pooled over all chains;
- ε adapts by the pooled dual averaging of HMC (inference/hmc.da_update),
  the diagonal mass by the same windowed schedule
  (inference/adaptation.warmup_schedule) with a batched Welford merge.

``L_t`` is a device scalar. Without ``static_unroll`` the transition reads
it back once an iteration (ONE host sync an iteration) and runs that many
steps. With ``static_unroll=K`` it runs min(K, max_leapfrog) masked steps,
each selected by ``i < L_t`` on the device: no host read, and no step
count above ``max_leapfrog`` (the reference ignores ``max_leapfrog`` there,
``modppl_tpu/inference/chees.py:225``).

Each chain's pre-drawn randoms come from its own lane stream keyed by its
global index (``inference/hmc._lane_draws``, as the reference's
``fold_in(segment_key, i)``), so a run over the shards of a mesh axis
(``axis_name``) replays the one-device chains; the pooled statistics
cross the shards through ``adaptation._pooled_sum``'s fixed add trees. The
tests carry the reference's draws through ``draws=``.
"""

import math

import numpy as np
import torch

from modppl_tpu_torch.core.keys import fold_in, split
from modppl_tpu_torch.inference.adaptation import (
    _pooled_sum,
    _window_metric,
    pooled_chains,
    warmup_phases,
)
from modppl_tpu_torch.inference.hmc import (
    _lane_draws,
    _segments,
    _stack_samples,
    _value_and_grad,
    da_init,
    da_update,
    flat_target,
    shard_chains,
    start_points,
)
from modppl_tpu_torch.modeling.handlers import entry_inputs


def halton(n, base=2):
    """First n terms of the base-``base`` Halton (radical-inverse)
    sequence, in (0, 1): the low-discrepancy trajectory jitter the ChEES
    paper recommends."""
    out = np.zeros(n)
    for i in range(n):
        f, r, x = 1.0, 0.0, i + 1
        while x > 0:
            f /= base
            r += f * (x % base)
            x //= base
        out[i] = r
    return out


def _adam_init(log_tau0):
    """Adam state on the scalar log τ (a 0-dim tensor)."""
    zero = torch.zeros_like(log_tau0)
    return {"log_tau": log_tau0, "m": zero, "v": zero, "t": zero}


def _adam_update(st, grad, lr, beta1=0.9, beta2=0.95, eps=1e-8):
    """One Adam step of gradient ASCENT on the ChEES criterion."""
    t = st["t"] + 1.0
    m = beta1 * st["m"] + (1.0 - beta1) * grad
    v = beta2 * st["v"] + (1.0 - beta2) * grad * grad
    mh = m / (1.0 - beta1 ** t)
    vh = v / (1.0 - beta2 ** t)
    log_tau = st["log_tau"] + lr * mh / (torch.sqrt(vh) + eps)
    return {"log_tau": log_tau, "m": m, "v": v, "t": t}


def _phase_randoms(seg_key, num_chains, length, dim, dtype, device,
                   offset=0):
    """One segment's pre-drawn randoms keyed ``seg_key``: momenta (W, C,
    d) standard normals and accept uniforms (W, C), chain i from its lane
    stream by its global index ``offset + i``; ``hmc._phase_randoms``
    without the step-size jitter (ChEES jitters the trajectory length
    instead)."""
    return _lane_draws(seg_key, num_chains, dim, dtype, device, length=length,
                       offset=offset, jitter=False)


def _chees_transition(vag, U, LP, G, eps, num_steps, inv_mass, mom_t,
                      acc_t, max_leapfrog, static_unroll=None):
    """One whole-batch jittered-HMC transition with ``num_steps`` leapfrog
    steps shared by every chain, capped at ``max_leapfrog``.

    Without ``static_unroll`` the step count is read on the host (one sync)
    and that many steps run. With ``static_unroll=K``, min(K, max_leapfrog)
    steps run, each masked by ``i < num_steps`` (steps past the count
    recompute the frozen state and are selected away): no host read.
    Returns (U', LP', G', aprob, divergent, u_prop, p_end): the proposal
    and its end momentum feed the ChEES gradient."""
    p0 = mom_t / torch.sqrt(inv_mass)[None, :]
    h0 = -LP + 0.5 * torch.sum(inv_mass[None, :] * p0 * p0, -1)

    def lf(u, p, lp, g):
        p = p + 0.5 * eps * g
        u = u + eps * inv_mass[None, :] * p
        lp, g = vag(u)
        p = p + 0.5 * eps * g
        return u, p, lp, g

    carry = (U, p0, LP, G)
    num_steps = torch.as_tensor(num_steps, device=U.device)
    if static_unroll is None:
        for _ in range(int(torch.clamp(num_steps, 1, max_leapfrog))):
            carry = lf(*carry)
    else:
        cap = min(static_unroll, max_leapfrog)
        n = torch.clamp(num_steps, 1, cap)
        for i in range(cap):
            new = lf(*carry)
            pred = i < n
            carry = tuple(torch.where(pred, a, b) for a, b in zip(new, carry))
    u, p, lp, g = carry
    h1 = -lp + 0.5 * torch.sum(inv_mass[None, :] * p * p, -1)
    delta_h = h0 - h1
    divergent = ~torch.isfinite(delta_h) | (delta_h < -1000.0)
    aprob = torch.where(divergent, 0.0,
                        torch.clamp(torch.exp(delta_h), max=1.0))
    acc = acc_t < aprob
    return (torch.where(acc[:, None], u, U), torch.where(acc, lp, LP),
            torch.where(acc[:, None], g, G), aprob, divergent, u, p)


def chees_runner(model, args, observed, *, num_samples=1000, num_warmup=500,
                 num_chains=2, step_size=0.1, init_traj_length=None,
                 target_accept=0.75, max_leapfrog=1000, adam_lr=0.025,
                 static_unroll=None, selection=None, init_trace=None,
                 axis_name=None, setup_key=0, device=None):
    """Build a reusable ChEES-HMC sampler: ``run(key) -> dict``.

    The output follows ``hmc_runner``'s, plus ``trajectory_length`` (the
    adapted τ) and ``num_leapfrog`` (the sampling phase's step count an
    iteration, shared by all chains). ``static_unroll=K`` runs each
    trajectory as K masked steps with no host read (pick K around τ/ε; the
    jittered mean count is τ/(2ε)); without it each iteration reads its
    step count back once. Set-up (initial trace, bijectors) happens here;
    everything runs on ``device``: the card unless the caller passes
    ``device="cpu"``. ``run.chains(k_run, u0s, draws=None)`` runs the
    pipeline from given start points (C, d); ``run.constrain_flat`` and
    ``run.u0_flat`` expose the flat coordinates.

    ``axis_name`` names a mesh axis (parallel/mesh.py) to shard the chains
    over, as ``hmc.hmc_runner``'s does: ``num_chains`` is the total, each
    rank runs (inside ``with mesh:``) its shard's chains by their global
    indices on its shard device, the pooled (eps, tau, mass) from every
    shard's chains; ``run.chains`` then takes the shard's start points.
    """
    if num_chains < 2:
        raise ValueError("chees: pooled trajectory adaptation needs "
                         "num_chains >= 2 (the criterion is a cross-chain "
                         "variance)")
    if axis_name is not None:
        from modppl_tpu_torch.parallel.mesh import shard_device

        device = shard_device(device)
    device, args, observed = entry_inputs(device, args, observed,
                                          "chees_runner")
    if init_trace is None:
        init_trace, _ = model.generate(setup_key, args, observed,
                                       device=device)
    target = flat_target(model, args, init_trace, observed, selection,
                         device=device)
    u0_flat, constrain_flat = target.u0, target.constrain
    dim, dt = u0_flat.shape[0], u0_flat.dtype
    vag = _value_and_grad(target.logprob)

    tau0 = (float(init_traj_length) if init_traj_length is not None
            else max(8.0 * step_size, 0.5))
    max_eff = (max_leapfrog if static_unroll is None
               else min(static_unroll, max_leapfrog))
    # the shared Halton jitter, one entry an iteration; sampling keeps
    # jittering (it is part of the kernel, not of the adaptation)
    h_warm = torch.as_tensor(halton(num_warmup), dtype=dt, device=device)
    h_samp = torch.as_tensor(halton(num_samples), dtype=dt, device=device)
    log_tau_lo = torch.log(torch.tensor(1e-3, dtype=dt, device=device))
    log_tau_hi = torch.log(torch.tensor(1e3, dtype=dt, device=device))

    def chains(k_run, u0s, draws=None):
        """The pipeline over start points ``u0s`` (C, d). ``draws``, one
        (momenta (T, C, d), accept uniforms (T, C)) a phase (the warmup's,
        then sampling; interop.chees_phase_draws carries the reference's),
        replaces the segments drawn from ``k_run``. Returns (us (C, S, d),
        logps, aprobs, divs (C, S), num_leapfrog (S,), eps, tau)."""
        c_all, offset = pooled_chains(u0s.shape[0], axis_name)
        c_total = u0s.new_tensor(float(c_all))

        def psum(x):
            return _pooled_sum(x, axis_name)

        phases = warmup_phases(num_warmup)
        if draws is not None and len(draws) != len(phases) + 1:
            raise ValueError(f"draws: expected one entry per phase "
                             f"({len(phases) + 1}), got {len(draws)}")
        phase_draws = iter(draws if draws is not None
                           else [None] * (len(phases) + 1))

        def steps(phase_key, length):
            given = next(phase_draws)
            if given is not None:
                return zip(*given)
            return _segments(phase_key, length, lambda k, w: _phase_randoms(
                k, u0s.shape[0], w, dim, dt, u0s.device, offset))

        def body(carry, mom_t, acc_t, h_t, inv_mass, adapt_mass, adapt):
            U, LP, G, da, adam, mean, m2, n = carry
            eps = torch.exp(da["log_eps"])
            tau = torch.exp(adam["log_tau"])
            num_steps = torch.clamp(torch.ceil(h_t * tau / eps), 1,
                                    max_eff).to(torch.int32)
            U2, LP2, G2, aprob, div, u_prop, p_end = _chees_transition(
                vag, U, LP, G, eps, num_steps, inv_mass, mom_t, acc_t,
                max_leapfrog, static_unroll=static_unroll)
            if adapt:
                a_sum = psum(aprob)
                da = da_update(da, a_sum / c_total, target=target_accept)
                # keep tau >= 2 eps: if eps outgrows tau the step count
                # pins at 1 and tau stops affecting the kernel (its
                # gradient turns to noise); raising tau leaves dual
                # averaging free
                floor = da["log_eps"] + math.log(2.0)
                adam = dict(adam, log_tau=torch.maximum(adam["log_tau"],
                                                        floor))
                # the ChEES gradient wrt tau (paper eq. 14, accept-weighted),
                # divergent chains masked out before the products
                fin = (~div & torch.all(torch.isfinite(u_prop), -1)
                       & torch.all(torch.isfinite(p_end), -1))
                u_safe = torch.where(fin[:, None], u_prop, 0.0)
                p_safe = torch.where(fin[:, None], p_end, 0.0)
                ubar = psum(U) / c_total
                n_fin = torch.clamp(psum(fin.to(dt)), min=1.0)
                ubar_p = psum(u_safe) / n_fin
                d_prev = torch.sum((U - ubar[None, :]) ** 2, -1)
                cent = u_safe - ubar_p[None, :]
                d_prop = torch.sum(cent * cent, -1)
                proj = torch.sum(cent * (inv_mass[None, :] * p_safe), -1)
                per_chain = torch.where(fin, aprob * (d_prop - d_prev) * proj,
                                        0.0)
                grad = h_t * psum(per_chain) / torch.clamp(a_sum, min=1e-6)
                # normalize the scale so Adam's lr is problem-independent
                grad = grad / (1.0 + torch.abs(grad))
                grad = torch.where(torch.isfinite(grad), grad, 0.0)
                adam = _adam_update(adam, grad, adam_lr)
                adam = dict(adam, log_tau=torch.clamp(
                    adam["log_tau"], log_tau_lo, log_tau_hi))
            if adapt_mass:
                # the batched (Chan) Welford merge of the iteration's draws
                b_mean = psum(U2) / c_total
                b_m2 = psum((U2 - b_mean[None]) ** 2)
                n_new = n + c_total
                delta = b_mean - mean
                mean = mean + delta * c_total / n_new
                m2 = m2 + b_m2 + delta * delta * n * c_total / n_new
                n = n_new
            return (U2, LP2, G2, da, adam, mean, m2, n), (U2, LP2, aprob, div,
                                                          num_steps)

        def run_phase(phase_key, carry, inv_mass, start, length, adapt_mass,
                      adapt, h_stream, collect=False):
            ys = []
            for i, (mom_t, acc_t) in enumerate(steps(phase_key, length)):
                carry, y = body(carry, mom_t, acc_t, h_stream[start + i],
                                inv_mass, adapt_mass, adapt)
                if collect:
                    ys.append(y)
            return carry, ys

        zeros = u0s.new_zeros(dim)
        n0 = u0s.new_zeros(())
        inv_mass = torch.ones_like(zeros)
        LP0, G0 = vag(u0s)
        carry = (u0s, LP0, G0, da_init(u0s.new_tensor(float(step_size))),
                 _adam_init(torch.log(u0s.new_tensor(tau0))), zeros, zeros,
                 n0)
        k_warm = fold_in(k_run, 0)
        start = 0
        for phase, (length, slow) in enumerate(phases):
            carry, _ = run_phase(fold_in(k_warm, phase), carry, inv_mass,
                                 start, length, slow, True, h_warm)
            start += length
            if slow:
                U, LP, G, da, adam, mean, m2, n = carry
                inv_mass = _window_metric(m2, n)
                carry = (U, LP, G, da_init(torch.exp(da["log_eps_bar"])),
                         adam, zeros, zeros, n0)
        U, LP, G, da, adam = carry[:5]
        eps = torch.exp(da["log_eps_bar"])
        tau = torch.exp(adam["log_tau"])

        # sampling: frozen (eps, tau, inv_mass); the Halton jitter stays on
        carry = (U, LP, G, da_init(eps),
                 dict(_adam_init(torch.log(tau)), log_tau=adam["log_tau"]),
                 zeros, zeros, n0)
        _, ys = run_phase(fold_in(k_run, 2), carry, inv_mass, 0, num_samples,
                          False, False, h_samp, collect=True)
        us, logps, aprobs, divs = _stack_samples([y[:4] for y in ys])
        nsteps = torch.stack([y[4] for y in ys])
        return us, logps, aprobs, divs, nsteps, eps, tau

    def run(k_run):
        # overdispersed start points around the initial trace, chain i's
        # jitter keyed by its global index
        u0s = start_points(k_run, u0_flat, *shard_chains(num_chains,
                                                         axis_name))
        us, logps, aprobs, divs, nsteps, eps, tau = chains(k_run, u0s)
        return {
            "samples": constrain_flat(us),
            "logp": logps,
            "accept_prob": aprobs,
            "divergences": divs,
            "step_size": eps,
            "trajectory_length": tau,
            "num_leapfrog": nsteps,
            "unconstrained": us,
        }

    run.chains = chains
    run.constrain_flat = constrain_flat
    run.u0_flat = u0_flat
    return run


def chees(key, model, args, observed, **config):
    """One-shot ChEES-HMC (see :func:`chees_runner` for the contract)."""
    k_init, k_run = split(key)
    return chees_runner(model, args, observed, setup_key=k_init,
                        **config)(k_run)
