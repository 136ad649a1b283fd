"""Tempered SMC sampler: annealed importance sampling with rejuvenation
(counterpart of modppl_tpu/inference/smc_sampler.py).

N particles of a static model move from the prior to the posterior through
a likelihood-tempering ladder

    pi_beta(u)  propto  prior(u) * likelihood(u)^beta,   0 = b0 < ... < bK = 1

with importance reweighting between rungs, systematic resampling on ESS
decay and HMC (or MALA) moves at each rung; the output is posterior draws
and an unbiased log-marginal-likelihood estimate.

The particles are an (N, D) tensor in unconstrained space (the ported
``latent_bijectors`` / ``ravel_latents``), their log-densities one
``torch.func.vmap`` over the particles and the move's gradients one
``vmap(grad_and_value)`` call a leapfrog step, as the generic HMC path
computes them. Particle i's draws are keyed ``split(k, N)[i]`` (lane keys,
core/keys.py). The reference's ``lax.cond`` on the ESS becomes both arms
and a select on the device: every rung resamples through
``systematic_parents``, which on a CUDA tensor launches kernel 4
(``grid_rank``) once, and keeps the old particles where the ESS is high, so
``smc_sampler`` launches kernel 4 once a rung and reads nothing back.
``adaptive_smc_sampler``'s ``while_loop`` is a host loop with one read a
rung (whether beta reached 1); its bisection runs on the device.

GFI decomposition (model-agnostic), with latent choices u: one fully
constrained generate of latents(u) + obs gives logjoint(u) (its weight)
and loglik(u) (the observed addresses' recorded logps), and logprior(u) =
logjoint(u) - loglik(u). The reference assesses the prior with only the
latents constrained, which draws the observed sites from a placeholder key
and drops them; here they hold their observed values and nothing is drawn
(a draw under ``torch.func.vmap`` would raise), with the same density.
"""

import math

import torch

from modppl_tpu_torch.core.keys import (
    fold_in,
    normal_lanes,
    split,
    split_keys,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.hmc import (
    _value_and_grad,
    latent_bijectors,
    ravel_latents,
)
from modppl_tpu_torch.modeling.handlers import entry_inputs
from modppl_tpu_torch.parallel.resample import RESAMPLERS


def make_tempered_logprobs(model, args, trace, observed, selection=None,
                           device=None):
    """(logprior, loglik, u0_flat, unravel, constrain) over flat u; the
    log-densities of one point (d,), ``constrain`` and ``unravel`` over any
    leading axes."""
    joint_and_lik, u0_flat, unravel, constrain = _tempered_parts(
        model, args, trace, observed, selection, device)

    def logprior_flat(u_flat):
        joint, lik = joint_and_lik(u_flat)
        return joint - lik

    def loglik_flat(u_flat):
        return joint_and_lik(u_flat)[1]

    return logprior_flat, loglik_flat, u0_flat, unravel, constrain


def _tempered_parts(model, args, trace, observed, selection, device):
    """(joint_and_lik, u0_flat, unravel, constrain): ``joint_and_lik(u)``
    is (logjoint(u), loglik(u)) of one point from ONE generate."""
    bijectors = latent_bijectors(trace, observed, selection)
    u0 = {addr: bijectors[addr].inverse(trace.data.read(addr))
          for addr in bijectors}
    u0_flat, unravel = ravel_latents(u0)

    def latent_constraints(u):
        t = Trie()
        ldj = 0.0
        for addr, bij in bijectors.items():
            t.observe(addr, bij.forward(u[addr]))
            ldj = ldj + bij.log_det_jacobian(u[addr])
        return t, ldj

    obs_addrs = observed.addresses()

    def joint_and_lik(u_flat):
        # one fully constrained generate: it draws nothing (the key is a
        # placeholder), its weight is the log joint, the observations'
        # recorded logps are the likelihood
        t, ldj = latent_constraints(unravel(u_flat))
        t.merge(observed.copy())
        trace, w = model.generate(0, args, t, device=device)
        lik = 0.0
        for addr in obs_addrs:
            lik = lik + trace.data.search(addr).weight()
        return w + ldj, lik

    def constrain(u_flat):
        u = unravel(u_flat)
        return {addr: bijectors[addr].forward(u[addr]) for addr in bijectors}

    return joint_and_lik, u0_flat, unravel, constrain


def tempered(joint_and_lik, beta):
    """log pi_beta(u) = logprior(u) + beta loglik(u), as logjoint(u) + (beta
    - 1) loglik(u): one generate a point."""
    def logdens(u_flat, beta=beta):
        joint, lik = joint_and_lik(u_flat)
        return joint + (beta - 1.0) * lik

    return logdens


def _tempered_hmc_move(keys, u, vag, eps, num_leapfrog, draws=None):
    """One HMC transition of every particle targeting the density whose
    batched value-and-grad is ``vag`` (U (N, d) -> (logp (N,), grad)), no
    adaptation. Particle i's momentum and accept uniform come from
    ``split(keys[i])``, or ``draws=(p0 (N, d), u01 (N,))``. Returns (u,
    accept)."""
    if draws is None:
        k_mom, k_acc = split_lanes(keys, 2).unbind(-1)
        p0 = normal_lanes(k_mom, tuple(u.shape[1:]), u.dtype)
        u01 = uniform_lanes(k_acc, (), u.dtype)
    else:
        p0, u01 = draws
    lp0, g = vag(u)
    q, p = u, p0
    for _ in range(num_leapfrog):
        p = p + 0.5 * eps * g
        q = q + eps * p
        lp1, g = vag(q)
        p = p + 0.5 * eps * g
    if num_leapfrog == 0:
        lp1 = lp0
    h0 = -lp0 + 0.5 * torch.sum(p0 * p0, dim=-1)
    h1 = -lp1 + 0.5 * torch.sum(p * p, dim=-1)
    accept = torch.log(u01) < h0 - h1
    return torch.where(accept[:, None], q, u), accept


def _tempered_mala_move(keys, u, vag, eps, draws=None):
    """One MALA (Langevin) transition of every particle, keyed as
    ``_tempered_hmc_move``; ``draws=(noise (N, d), u01 (N,))``."""
    if draws is None:
        k_noise, k_acc = split_lanes(keys, 2).unbind(-1)
        noise = normal_lanes(k_noise, tuple(u.shape[1:]), u.dtype)
        u01 = uniform_lanes(k_acc, (), u.dtype)
    else:
        noise, u01 = draws
    lp, g = vag(u)
    prop = u + 0.5 * eps * eps * g + eps * noise
    lp_prop, g_prop = vag(prop)
    # q(u | prop) / q(prop | u)
    fwd = -torch.sum((prop - u - 0.5 * eps * eps * g) ** 2,
                     dim=-1) / (2 * eps * eps)
    bwd = -torch.sum((u - prop - 0.5 * eps * eps * g_prop) ** 2,
                     dim=-1) / (2 * eps * eps)
    alpha = lp_prop - lp + bwd - fwd
    accept = torch.log(u01) < alpha
    return torch.where(accept[:, None], prop, u), accept


def _moves(key, u, joint_and_lik, beta, num_moves, move, step_size,
           num_leapfrog, what):
    """``num_moves`` moves under pi_beta, move m keyed ``fold_in(key, m)``
    and particle i ``split(that, N)[i]``. Returns (u, the mean accept)."""
    if move not in ("hmc", "mala"):
        raise ValueError(f"{what}: unknown move {move!r}")
    vag = _value_and_grad(tempered(joint_and_lik, beta))
    accepts = torch.zeros((), dtype=u.dtype, device=u.device)
    for m in range(num_moves):
        keys = split_keys(fold_in(key, m), u.shape[0], u.device)
        if move == "hmc":
            u, acc = _tempered_hmc_move(keys, u, vag, step_size, num_leapfrog)
        else:
            u, acc = _tempered_mala_move(keys, u, vag, step_size)
        accepts = accepts + torch.mean(acc.to(u.dtype))
    return u, accepts / max(num_moves, 1)


def _prior_particles(key, model, args, observed, selection, n, device):
    """N prior draws in one lane-keyed simulate (particle i keyed
    ``split(key, N)[i]``), pulled through the bijectors and raveled in
    ``ravel_latents``' order: (N, d)."""
    tr = model.simulate(split_keys(key, n, device), args)
    bij = latent_bijectors(tr, observed, selection)
    return torch.cat([bij[a].inverse(tr.data.read(a)).reshape(n, -1)
                      for a in sorted(bij)], dim=1)


def _setup(key, model, args, observed, selection, n, device):
    """The tempered log-densities, the initial particles and the rung key:
    keys ``split(key, 3)`` = (particles, trace, rungs), as the reference."""
    k_init, k_tr, k_loop = split(key, 3)
    init_trace, _ = model.generate(k_tr, args, observed, device=device)
    joint_and_lik, _, _, constrain = _tempered_parts(
        model, args, init_trace, observed, selection, device)
    u = _prior_particles(k_init, model, args, observed, selection, n, device)
    return joint_and_lik, constrain, u, k_loop


def _reweight_resample(k_res, u, lw, log_ml, resampler, ess_threshold, n):
    """The ESS of ``lw`` and, both arms and a select on the device, the
    particles resampled where it is below ``ess_threshold`` N."""
    log_total = torch.logsumexp(lw, 0)
    log_norm = lw - log_total
    ess = torch.exp(-torch.logsumexp(2.0 * log_norm, 0))
    do = ess < ess_threshold * n
    parents = resampler(k_res, log_norm)
    u = torch.where(do, torch.index_select(u, 0, parents.long()), u)
    lw = torch.where(do, torch.zeros_like(lw), lw)
    log_ml = torch.where(do, log_ml + log_total - math.log(float(n)), log_ml)
    return u, lw, log_ml, ess


def _finish(u, lw, log_ml, constrain, n):
    log_total = torch.logsumexp(lw, 0)
    return {"particles": constrain(u), "unconstrained": u,
            "log_weights": lw - log_total,
            "log_ml": log_ml + log_total - math.log(float(n))}


def smc_sampler(key, model, args, observed, *, num_particles,
                num_temps=20, betas=None, num_moves=2, move="hmc",
                step_size=0.1, num_leapfrog=8, ess_threshold=0.5,
                resampling="systematic", selection=None, device=None):
    """Run the tempered SMC sampler, on the card unless ``device`` names
    another.

    ``observed`` is the constraint Trie of observations; ``num_temps`` the
    rungs of the default cosine ladder (ignored when ``betas``, increasing
    and ending at 1, is given); ``num_moves`` rejuvenation transitions a
    rung, ``move`` "hmc" or "mala"; a rung resamples where ESS <
    ``ess_threshold`` N.

    Returns a dict: ``particles`` {addr: (N, ...)}, ``unconstrained``
    (N, d), ``log_weights`` (normalized), ``log_ml``, ``ess`` and
    ``accept_rate`` (one a rung) and ``betas``.
    """
    device, args, observed = entry_inputs(device, args, observed,
                                          "smc_sampler")
    n = num_particles
    joint_and_lik, constrain, u, k_scan = _setup(
        key, model, args, observed, selection, n, device)
    if betas is None:
        # cosine schedule: dense near 0, where the likelihood bites hardest
        ts = torch.linspace(0.0, 1.0, num_temps + 1, dtype=u.dtype,
                            device=device)[1:]
        betas = (1.0 - torch.cos(ts * math.pi / 2)) ** 2
        betas = betas / betas[-1]
    betas = torch.as_tensor(betas, dtype=u.dtype, device=device)
    resampler = RESAMPLERS[resampling]
    loglik_v = torch.func.vmap(lambda ui: joint_and_lik(ui)[1])
    lw = torch.zeros(n, dtype=u.dtype, device=device)
    log_ml = torch.zeros((), dtype=u.dtype, device=device)
    beta_prev = torch.zeros((), dtype=u.dtype, device=device)
    ess_hist, acc_hist = [], []
    for beta, k in zip(betas, split(k_scan, betas.shape[0])):
        k_res, k_move = split(k)
        lw = lw + (beta - beta_prev) * loglik_v(u)
        u, lw, log_ml, ess = _reweight_resample(
            k_res, u, lw, log_ml, resampler, ess_threshold, n)
        u, acc = _moves(k_move, u, joint_and_lik, beta, num_moves, move,
                        step_size, num_leapfrog, "smc_sampler")
        ess_hist.append(ess)
        acc_hist.append(acc)
        beta_prev = beta
    return {**_finish(u, lw, log_ml, constrain, n),
            "ess": torch.stack(ess_hist), "accept_rate": torch.stack(acc_hist),
            "betas": betas}


def _ess_of(lw):
    log_norm = lw - torch.logsumexp(lw, 0)
    return torch.exp(-torch.logsumexp(2.0 * log_norm, 0))


def _pick_delta(lw, ll, beta, target_ess, bisect_iters):
    """The largest increment delta <= 1 - beta keeping the ESS of the
    reweighted particles at least ``target_ess`` times the current ESS
    (Jasra et al.; relative, so that beta always reaches 1): the whole
    step if it keeps it, else ``bisect_iters`` halvings, on the device,
    returning the feasible end (never below (1 - beta) 1e-6)."""
    hi0 = 1.0 - beta
    floor = target_ess * _ess_of(lw)
    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        ok = _ess_of(lw + mid * ll) >= floor
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    bisected = torch.maximum(lo, hi0 * 1e-6)
    return torch.where(_ess_of(lw + hi0 * ll) >= floor, hi0, bisected)


def adaptive_smc_sampler(key, model, args, observed, *, num_particles,
                         target_ess=0.9, max_temps=100, num_moves=2,
                         move="hmc", step_size=0.1, num_leapfrog=8,
                         ess_threshold=0.5, resampling="systematic",
                         selection=None, bisect_iters=30, device=None):
    """Tempered SMC with an ESS-adapted ladder, on the card unless
    ``device`` names another: each rung's increment is ``_pick_delta``'s.
    A host loop with one read a rung (beta < 1) runs at most
    ``max_temps`` rungs.

    Returns :func:`smc_sampler`'s dict plus ``num_temps`` (rungs used, an
    int); ``betas``, ``ess`` and ``accept_rate`` are (max_temps,) buffers
    valid up to it, NaN beyond.
    """
    device, args, observed = entry_inputs(device, args, observed,
                                          "adaptive_smc_sampler")
    n = num_particles
    joint_and_lik, constrain, u, k = _setup(
        key, model, args, observed, selection, n, device)
    resampler = RESAMPLERS[resampling]
    loglik_v = torch.func.vmap(lambda ui: joint_and_lik(ui)[1])
    lw = torch.zeros(n, dtype=u.dtype, device=device)
    log_ml = torch.zeros((), dtype=u.dtype, device=device)
    beta = torch.zeros((), dtype=u.dtype, device=device)
    betas, ess_hist, acc_hist = [], [], []
    t = 0
    while t < max_temps:
        k, k_res, k_move = split(k, 3)
        ll = loglik_v(u)
        delta = _pick_delta(lw, ll, beta, target_ess, bisect_iters)
        beta = beta + delta
        lw = lw + delta * ll
        u, lw, log_ml, ess = _reweight_resample(
            k_res, u, lw, log_ml, resampler, ess_threshold, n)
        u, acc = _moves(k_move, u, joint_and_lik, beta, num_moves, move,
                        step_size, num_leapfrog, "adaptive_smc_sampler")
        betas.append(beta)
        ess_hist.append(ess)
        acc_hist.append(acc)
        t += 1
        if not float(beta) < 1.0:   # the one host read of the rung
            break

    def padded(xs):
        out = torch.full((max_temps,), math.nan, dtype=u.dtype, device=device)
        out[:len(xs)] = torch.stack(xs)
        return out

    return {**_finish(u, lw, log_ml, constrain, n), "ess": padded(ess_hist),
            "accept_rate": padded(acc_hist), "betas": padded(betas),
            "num_temps": t}
