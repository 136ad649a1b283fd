"""Hamiltonian Monte Carlo with dual-averaging step size and diagonal mass
adaptation (counterpart of modppl_tpu/inference/hmc.py).

``hmc_runner`` builds the latent log-density over unconstrained space from
the model's ``assess`` (bijectors per address from the trie's recorded
distributions), then takes one of three paths:

- a quadratic target (logp = b.u - u.Λu/2 + const: every all-Gaussian
  model with identity bijectors) runs the whole pooled warmup and the
  whole sampling phase as one kernel launch each (``_quadratic_chains``):
  the ops/leapfrog_small.py kernels at d <= 12, the ops/leapfrog.py
  kernels above;
- any other target, or ``use_fused_quadratic=False``, runs the generic
  path: ``torch.func.vmap(torch.func.grad_and_value(logprob))`` gives every
  chain's (logp, grad) at each leapfrog step, with one shared adapted
  (eps, inv_mass) (``_pooled_chains``, the default for more than one chain)
  or one per chain (``_single_chain``, the whole batch at once).

Adaptation state, accept probabilities and flags stay on the device: the
generic path reads nothing back to the host per transition. Every chain
draws from its own lane stream keyed by its global index (``_lane_draws``),
so a run over the shards of a mesh axis (``axis_name``, parallel/mesh.py)
replays the one-device chains.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from modppl_tpu_torch.core.keys import (
    fold_in,
    generator,
    lanes,
    normal_lanes,
    split,
    split_keys,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.inference.transforms import transform_for
from modppl_tpu_torch.modeling.handlers import entry_inputs
from modppl_tpu_torch.utils.profiling import annotate

# below this dimension the d <= 12 kernels run (ops/leapfrog_small.py),
# from it the d >= 13 kernels (ops/leapfrog.py), as in the reference
FUSED_QUADRATIC_MIN_DIM = 13


# --------------------------------------------------------------------------
# Unconstrained log-joint construction
# --------------------------------------------------------------------------

def latent_bijectors(trace, observed, selection=None):
    """Map each non-observed continuous address to its bijector. Discrete
    latent addresses raise: gradients cannot flow through them."""
    out = {}
    discrete = []
    for addr in trace.data.addresses():
        if observed.search(addr) is not None:
            continue
        if selection is not None and selection.search(addr) is None:
            continue
        node = trace.data.search(addr)
        if node.dist is None:
            continue  # not a random choice
        if node.dist.is_discrete:
            discrete.append(addr)
            continue
        bij = transform_for(node.dist)
        if bij is None:
            raise ValueError(
                f'hmc: no default unconstraining bijector for address "{addr}" '
                f"(dist {node.dist!r}, support {node.dist.support!r}); "
                "condition it or pass an explicit transform")
        out[addr] = bij
    if discrete:
        raise ValueError(
            f"hmc: discrete latent addresses {discrete} — observe them, "
            "marginalize them, or use MH/SMC for those choices")
    return out


def make_unconstrained_logprob(model, args, trace, observed, selection=None,
                               include_jacobian=True, device=None):
    """Build ``logprob(u) -> 0-dim tensor`` over unconstrained latents.

    Returns (logprob, u0, bijectors, constrain): u0 is the unconstrained
    image of the trace's latent values and ``constrain(u)`` maps back to an
    {addr: value} dict. ``include_jacobian=False`` drops the
    log-det-Jacobian term. ``device`` is handed to ``model.assess``.
    """
    bijectors = latent_bijectors(trace, observed, selection)

    def constrain(u):
        return {addr: bijectors[addr].forward(u[addr]) for addr in bijectors}

    def logprob(u):
        constraints = observed.copy()
        ldj = 0.0
        for addr, bij in bijectors.items():
            constraints.observe(addr, bij.forward(u[addr]))
            if include_jacobian:
                ldj = ldj + bij.log_det_jacobian(u[addr])
        # fully-constrained generate: the weight is the log joint
        return model.assess(0, args, constraints, device=device) + ldj

    u0 = {addr: bijectors[addr].inverse(trace.data.read(addr))
          for addr in bijectors}
    return logprob, u0, bijectors, constrain


def ravel_latents(u):
    """(flat, unravel) for an {addr: tensor} dict, in sorted key order as
    ``jax.flatten_util.ravel_pytree`` lays a dict out. ``unravel`` takes
    any leading batch axes: (..., dim) -> {addr: (...,) + shape}."""
    keys = sorted(u)
    shapes = [tuple(torch.as_tensor(u[k]).shape) for k in keys]
    sizes = [max(1, int(torch.Size(s).numel())) for s in shapes]
    flat = torch.cat([torch.as_tensor(u[k]).reshape(-1) for k in keys])

    def unravel(x):
        out, off = {}, 0
        lead = tuple(x.shape[:-1])
        for k, s, n in zip(keys, shapes, sizes):
            out[k] = x[..., off:off + n].reshape(lead + s)
            off += n
        return out

    return flat, unravel


class FlatTarget(NamedTuple):
    """An unconstrained log-joint over one flat coordinate vector."""

    logprob: Callable      # u (d,) -> 0-dim tensor
    u0: torch.Tensor       # (d,): the initial trace's latents, unconstrained
    constrain: Callable    # u (..., d) -> {addr: value}, constrained
    unravel: Callable      # u (..., d) -> {addr: value}, unconstrained
    bijectors: dict        # {addr: Bijector}


def flat_target(model, args, trace, observed, selection=None,
                include_jacobian=True, device=None):
    """:func:`make_unconstrained_logprob` raveled to one flat coordinate
    vector (in ``ravel_latents``' order), u0 on ``device``."""
    logprob, u0, bijectors, constrain = make_unconstrained_logprob(
        model, args, trace, observed, selection,
        include_jacobian=include_jacobian, device=device)
    u0_flat, unravel = ravel_latents(u0)
    return FlatTarget(lambda u: logprob(unravel(u)), u0_flat.to(device),
                      lambda u: constrain(unravel(u)), unravel, bijectors)


def _value_and_grad(logprob):
    """``U (C, d) -> (logp (C,), grad (C, d))`` from a per-point ``logprob``:
    the counterpart of ``jax.vmap(jax.value_and_grad(logprob))``."""
    vg = torch.func.vmap(torch.func.grad_and_value(logprob))

    def vag(U):
        g, lp = vg(U)
        return lp, g

    return vag


# --------------------------------------------------------------------------
# Leapfrog + transition
# --------------------------------------------------------------------------

def _leapfrog(grad_fn, u, p, eps, num_steps, inv_mass):
    """Standard leapfrog in flat coordinates, ``num_steps`` steps."""
    g = grad_fn(u)
    for _ in range(num_steps):
        p = p + 0.5 * eps * g
        u = u + eps * inv_mass * p
        g = grad_fn(u)
        p = p + 0.5 * eps * g
    return u, p


def hmc_transition(key, u_flat, logp_flat, grad_flat, eps, num_leapfrog,
                   inv_mass, draws=None):
    """One HMC transition on flat unconstrained coordinates.

    One chain (u_flat (d,), eps and the draws scalars) or a batch (u_flat
    (C, d), eps (C,) or scalar, inv_mass (d,) or (C, d)); ``logp_flat`` and
    ``grad_flat`` take what ``u_flat`` is. The step size is jittered ±50%
    per transition, momenta are z / sqrt(inv_mass), and a transition whose
    energy error is not finite or below -1000 is divergent and rejected.
    The draws come from the chains' lane streams keyed ``key``
    (:func:`_lane_draws`, chain i's from ``fold_in(key, i)``; one chain is
    chain 0): standard normals z, a step-size jitter in [0.5, 1.5) and an
    accept uniform u01 a chain; ``draws`` = (z, jit, u01) replaces them.
    Returns (u', logp(u'), accept_prob, divergent).
    """
    if draws is None:
        one = u_flat.ndim == 1
        draws = _lane_draws(key, 1 if one else u_flat.shape[0],
                            u_flat.shape[-1], u_flat.dtype, u_flat.device)
        if one:
            draws = tuple(x[0] for x in draws)
    z, jit, u01 = draws
    eps = (eps * jit)[..., None]
    p0 = z / torch.sqrt(inv_mass)
    logp0 = logp_flat(u_flat)
    u_new, p_new = _leapfrog(grad_flat, u_flat, p0, eps, num_leapfrog,
                             inv_mass)
    logp_new = logp_flat(u_new)
    h0 = -logp0 + 0.5 * torch.sum(inv_mass * p0 * p0, -1)
    h_new = -logp_new + 0.5 * torch.sum(inv_mass * p_new * p_new, -1)
    delta_h = h0 - h_new
    divergent = ~torch.isfinite(delta_h) | (delta_h < -1000.0)
    accept_prob = torch.where(divergent, 0.0,
                              torch.clamp(torch.exp(delta_h), max=1.0))
    accept = u01 < accept_prob
    u_out = torch.where(accept[..., None], u_new, u_flat)
    logp_out = torch.where(accept, logp_new, logp0)
    return u_out, logp_out, accept_prob, divergent


# --------------------------------------------------------------------------
# Dual averaging (Hoffman & Gelman 2014, Algorithm 5 constants)
# --------------------------------------------------------------------------

def da_init(eps0):
    """Dual-averaging state around ``eps0`` (a tensor: scalars follow its
    dtype and device)."""
    log_eps = torch.log(eps0)
    zero = torch.zeros_like(log_eps)
    return {"log_eps": log_eps, "log_eps_bar": log_eps, "h_bar": zero,
            "mu": torch.log(10.0 * eps0), "t": zero}


def da_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0,
              kappa=0.75):
    t = state["t"] + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state["h_bar"] + eta_h * (target - accept_prob)
    log_eps = state["mu"] - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state["log_eps_bar"]
    return {"log_eps": log_eps, "log_eps_bar": log_eps_bar, "h_bar": h_bar,
            "mu": state["mu"], "t": t}


# --------------------------------------------------------------------------
# Quadratic-target detection (fused kernel dispatch)
# --------------------------------------------------------------------------

def _grad_at(logprob_flat, u):
    u = u.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(logprob_flat(u), u)
    return g.detach()


def detect_quadratic_target(logprob_flat, dim, dtype=torch.float32,
                            device="cuda", num_probes=3, tol=1e-5):
    """Detect logp(u) = -1/2 u^T Λ u + b^T u (+ const); return (Λ, b) or None.

    Λ = -hessian(0) and b = grad(0), in ``dtype`` on ``device`` (the card
    unless the caller passes ``device="cpu"``, as ``hmc_runner``); the target
    is quadratic when grad(u) == b - u Λ at probes of radius 1, 4 and 16
    (standard normals from ``torch.Generator``s seeded 100, 101, 102 on
    ``device``), within ``tol`` of 1 + max|grad(u)|.
    """
    z = torch.zeros(dim, dtype=dtype, device=device)
    lam = -torch.autograd.functional.hessian(logprob_flat, z).detach()
    g0 = _grad_at(logprob_flat, z)
    lam_c = lam.cpu().numpy()
    g0_c = g0.cpu().numpy()
    if not (np.isfinite(lam_c).all() and np.isfinite(g0_c).all()):
        return None
    for i in range(num_probes):
        u = (4.0 ** i) * torch.randn(dim, generator=generator(100 + i, device),
                                     dtype=dtype, device=device)
        gu = _grad_at(logprob_flat, u).cpu().numpy()
        pred = g0_c - u.cpu().numpy() @ lam_c
        scale = 1.0 + np.abs(gu).max()
        if not np.isfinite(gu).all() or np.abs(gu - pred).max() > tol * scale:
            return None
    return lam, g0


def _quadratic_chains(key, lam, b, u0s, num_warmup, num_samples, eps0,
                      num_leapfrog, target_accept, draws=None):
    """Pooled-adaptation HMC where the whole warmup and the whole sampling
    phase are one kernel launch each. ``draws`` = (warmup streams, sampling
    streams), each (z, jit, u01), replaces the streams drawn from ``key``
    (interop.phase_streams carries the reference's). Returns per-chain
    stacks (chains, samples, ...) and the shared (eps, inv_mass)."""
    if num_warmup < 1:
        raise ValueError("the fused quadratic path needs num_warmup >= 1")
    warm, samp = draws if draws is not None else (None, None)
    if u0s.shape[1] < FUSED_QUADRATIC_MIN_DIM:
        from modppl_tpu_torch.ops.leapfrog_small import (
            hmc_sample_chunk_small,
            hmc_warmup_chunk_small,
        )

        with annotate("modppl.hmc.warmup"):
            us, eps, inv_mass = hmc_warmup_chunk_small(
                fold_in(key, 0), u0s, float(eps0), lam, b, num_warmup,
                num_leapfrog, target_accept=target_accept, draws=warm)
        with annotate("modppl.hmc.sample"):
            us_t, logps, aprobs, divs, _ = hmc_sample_chunk_small(
                fold_in(key, 2), us, eps, lam, b, inv_mass, num_samples,
                num_leapfrog, draws=samp)
    else:
        from modppl_tpu_torch.ops.leapfrog import (
            hmc_sample_chunk,
            hmc_warmup_chunk,
        )

        with annotate("modppl.hmc.warmup"):
            us, eps, inv_mass = hmc_warmup_chunk(
                fold_in(key, 0), u0s, float(eps0), lam, b, num_warmup,
                num_leapfrog, target_accept=target_accept, draws=warm)
        with annotate("modppl.hmc.sample"):
            us_t, logps, aprobs, divs = hmc_sample_chunk(
                fold_in(key, 2), us, eps, lam, b, inv_mass, num_samples,
                num_leapfrog, draws=samp)
    # (samples, chains, ...) -> (chains, samples, ...)
    return (*(x.transpose(0, 1) for x in (us_t, logps, aprobs, divs)), eps,
            inv_mass)


# --------------------------------------------------------------------------
# The generic path
# --------------------------------------------------------------------------

# iterations per pre-drawn segment: bounds the resident draws to
# 64·C·(d+2) values a segment
_PREDRAW_SEG = 64


def _lane_draws(key, num_chains, dim, dtype, device, length=None, offset=0,
                jitter=True):
    """Per-chain randoms from lane streams: chain i (its global index
    ``offset + i``) draws from the lane key ``fold_in(key, offset + i)``,
    split three ways, so a chain's draws depend on its index and the shapes
    alone, never on the chain count or the shard. One transition's (z (C,
    d), jitter (C,) in [0.5, 1.5), accept uniform (C,)), or with ``length``
    W a segment's (W, C, d), (W, C), (W, C); without ``jitter`` (z, u)."""
    k_z, k_jit, k_u = split_lanes(lanes(key, num_chains, device,
                                        offset=offset), 3).unbind(-1)
    lead = () if length is None else (length,)
    z = normal_lanes(k_z, lead + (dim,), dtype)
    u = uniform_lanes(k_u, lead, dtype)
    if length is not None:
        z, u = z.transpose(0, 1), u.transpose(0, 1)
    if not jitter:
        return z, u
    jit = 0.5 + uniform_lanes(k_jit, lead, dtype)
    return z, (jit if length is None else jit.transpose(0, 1)), u


def start_points(key, u0, num_chains, offset=0):
    """Overdispersed start points ``u0 + 0.5 z`` (C, d), chain i's z from
    the lane key ``split(key, C)[offset + i]``, as the reference's
    ``split(k_run, C)`` keys them."""
    return u0[None, :] + 0.5 * normal_lanes(
        split_keys(key, num_chains, u0.device, offset=offset), u0.shape,
        u0.dtype)


def _phase_randoms(seg_key, num_chains, length, dim, dtype, device,
                   offset=0):
    """One segment's per-transition randoms on ``device``, keyed
    ``seg_key`` (``fold_in(phase_key, seg)``): momenta (W, C, d) standard
    normals, step-size jitters (W, C) in [0.5, 1.5) and accept uniforms
    (W, C), chain i from its lane stream (:func:`_lane_draws`), as the
    reference keys each chain by its global index."""
    return _lane_draws(seg_key, num_chains, dim, dtype, device, length=length,
                       offset=offset)


def _phase_steps(phase_key, length, u0s, draws=None, offset=0):
    """The per-iteration (z (C, d), jit (C,), u01 (C,)) of one phase for the
    chains ``u0s`` (C, d): the rows of ``draws`` = (z (T, C, d), jit (T, C),
    u01 (T, C)) when given, else segments of ``_PREDRAW_SEG`` iterations
    from :func:`_phase_randoms`, segment ``seg`` keyed
    ``fold_in(phase_key, seg)``, the chains from the global index
    ``offset``."""
    if draws is not None:
        if tuple(draws[0].shape) != (length,) + tuple(u0s.shape):
            raise ValueError(f"draws: a phase of {length} iterations over "
                             f"{tuple(u0s.shape)} chains needs z of shape "
                             f"{(length,) + tuple(u0s.shape)}, got "
                             f"{tuple(draws[0].shape)}")
        return zip(*draws)
    return _segments(phase_key, length, lambda k, w: _phase_randoms(
        k, u0s.shape[0], w, u0s.shape[1], u0s.dtype, u0s.device, offset))


def _segments(phase_key, length, draw):
    """A phase's per-iteration draws from segments of ``_PREDRAW_SEG``
    iterations: ``draw(fold_in(phase_key, seg), w)`` gives segment
    ``seg``'s tensors, each with a leading axis of its w iterations."""
    done, seg = 0, 0
    while done < length:
        w = min(_PREDRAW_SEG, length - done)
        yield from zip(*draw(fold_in(phase_key, seg), w))
        done += w
        seg += 1


def _phase_draws(draws, num_warmup):
    """An iterator over each phase's draws, the warmup's then sampling's
    (None for each when ``draws`` is None)."""
    from modppl_tpu_torch.inference.adaptation import warmup_phases

    num_phases = len(warmup_phases(num_warmup)) + 1
    if draws is None:
        return iter([None] * num_phases)
    if len(draws) != num_phases:
        raise ValueError(f"draws: expected one entry per phase "
                         f"({num_phases}: the warmup's, then sampling), got "
                         f"{len(draws)}")
    return iter(draws)


def _transition_batch(vag, U, LP, G, eps_shared, inv_mass, mom_t, jit_t,
                      acc_t, num_leapfrog):
    """One whole-batch HMC transition with pre-drawn randoms.

    The carry holds (positions, logp, grad), so neither the start
    log-density nor the start gradient is recomputed, and each leapfrog
    step makes ONE batched value-and-grad call, so the final logp is free.
    Per chain the arithmetic is :func:`hmc_transition`'s (the same
    divergence guard and accept rule) at the shared ``eps_shared`` and
    ``inv_mass`` (d,).
    """
    eps = (eps_shared * jit_t)[:, None]               # (C, 1)
    p0 = mom_t / torch.sqrt(inv_mass)[None, :]
    h0 = -LP + 0.5 * torch.sum(inv_mass[None, :] * p0 * p0, -1)
    u, p, lp, g = U, p0, LP, G
    for _ in range(num_leapfrog):
        p = p + 0.5 * eps * g
        u = u + eps * inv_mass[None, :] * p
        lp, g = vag(u)
        p = p + 0.5 * eps * g
    h1 = -lp + 0.5 * torch.sum(inv_mass[None, :] * p * p, -1)
    delta_h = h0 - h1
    divergent = ~torch.isfinite(delta_h) | (delta_h < -1000.0)
    aprob = torch.where(divergent, 0.0,
                        torch.clamp(torch.exp(delta_h), max=1.0))
    acc = acc_t < aprob
    U = torch.where(acc[:, None], u, U)
    LP = torch.where(acc, lp, LP)
    G = torch.where(acc[:, None], g, G)
    return U, LP, G, aprob, divergent


def _stack_samples(ys):
    """Per-iteration (U, LP, aprob, div) -> (chains, samples, ...) each."""
    return tuple(torch.stack(x, 1) for x in zip(*ys))


def _pooled_chains(key, logprob, u0s, num_warmup, num_samples, eps0,
                   num_leapfrog, target_accept, axis_name=None, draws=None):
    """All chains share ONE adapted (eps, inv_mass), pooled across chains.

    Batched transitions (:func:`_transition_batch`) on pre-drawn segments
    (:func:`_phase_randoms`), each leapfrog step one call of
    ``vmap(grad_and_value(logprob))`` over the whole batch. Warmup follows
    Stan's windows (``adaptation.warmup_schedule``): each slow window
    accumulates the draws' moment sums CENTRED at its start's pooled mean
    (the raw form cancels in float32 when |mean| >> sd), sets inv_mass to
    the regularized variance at its end, and restarts dual averaging at
    exp(log_eps_bar). Phase keys: warmup phase i ``fold_in(fold_in(key, 0),
    i)``, sampling ``fold_in(key, 2)``.

    ``u0s``: (C, dim). ``draws``, one (z, jit, u01) per phase (the warmup's
    in order, then sampling; z (T, C, d), the others (T, C)), replaces the
    drawn segments (interop.pooled_phase_draws carries the reference's).
    Returns (us, logps, aprobs, divs) as (chains, samples, ...), the shared
    eps () and inv_mass (dim,).

    Over the shards of ``axis_name`` (a mesh axis, inside ``with mesh:``)
    ``u0s`` is the shard's chains; each chain draws by its global index
    and the pooled statistics are the fixed-order sums of
    ``adaptation._pooled_sum`` over every shard's chains (one device uses
    ``torch.sum``), so dp = 1 and dp = k runs agree bitwise where the
    model's log-density is bitwise in the batch size.
    """
    from modppl_tpu_torch.inference.adaptation import (
        _pooled_sum,
        _window_metric,
        pooled_chains,
        warmup_phases,
    )

    vag = _value_and_grad(logprob)
    dim = u0s.shape[1]
    c_all, offset = pooled_chains(u0s.shape[0], axis_name)
    c_total = u0s.new_tensor(float(c_all))
    zeros = u0s.new_zeros(dim)
    phase_draws = _phase_draws(draws, num_warmup)

    def psum0(x):
        if axis_name is None:
            return torch.sum(x, 0)
        return _pooled_sum(x, axis_name)

    def run_phase(phase_key, carry, inv_mass, length, adapt_mass,
                  collect=False, adapt_da=True, ref=None):
        U, LP, G, da, s1, s2, n = carry
        ys = []
        for mom_t, jit_t, acc_t in _phase_steps(phase_key, length, U,
                                                next(phase_draws), offset):
            eps = torch.exp(da["log_eps"])
            U, LP, G, aprob, div = _transition_batch(
                vag, U, LP, G, eps, inv_mass, mom_t, jit_t, acc_t,
                num_leapfrog)
            if adapt_mass:
                # one reduction for the accept mean and the window's moment
                # sums, centred at the window-start pooled mean ``ref``
                Uc = U - ref[None, :]
                stat = psum0(torch.cat([aprob[:, None], Uc, Uc * Uc], 1))
                a_mean = stat[0] / c_total
                s1 = s1 + stat[1:1 + dim]
                s2 = s2 + stat[1 + dim:]
                n = n + c_total
            elif adapt_da:
                a_mean = psum0(aprob) / c_total
            if adapt_da:
                da = da_update(da, a_mean, target=target_accept)
            if collect:
                ys.append((U, LP, aprob, div))
        return (U, LP, G, da, s1, s2, n), ys

    def restart(U, LP, G, eps):
        return (U, LP, G, da_init(eps), zeros, zeros, u0s.new_zeros(()))

    inv_mass = torch.ones_like(zeros)
    carry = restart(u0s, *vag(u0s), u0s.new_tensor(float(eps0)))
    k_warm = fold_in(key, 0)
    for phase, (length, slow) in enumerate(warmup_phases(num_warmup)):
        # a slow window's moment sums are centred at its start's pooled mean
        ref = psum0(carry[0]) / c_total if slow else None
        carry, _ = run_phase(fold_in(k_warm, phase), carry, inv_mass, length,
                             slow, ref=ref)
        if slow:
            U, LP, G, da, s1, s2, n = carry
            # centred moments: the subtraction cancels at the scale of the
            # posterior's spread, not its location
            meanc = s1 / torch.clamp(n, min=1.0)
            inv_mass = _window_metric(torch.clamp(s2 - n * meanc * meanc,
                                                  min=0.0), n)
            carry = restart(U, LP, G, torch.exp(da["log_eps_bar"]))
    U, LP, G, da = carry[:4]
    eps = torch.exp(da["log_eps_bar"])

    # sampling: the same transition at the frozen (eps, inv_mass)
    _, ys = run_phase(fold_in(key, 2), restart(U, LP, G, eps), inv_mass,
                      num_samples, False, collect=True, adapt_da=False)
    return (*_stack_samples(ys), eps, inv_mass)


def _single_chain(key, logprob, u0s, num_warmup, num_samples, eps0,
                  num_leapfrog, target_accept, draws=None, offset=0):
    """Every chain adapts its own (eps, inv_mass) (``adaptation.run_warmup``)
    and samples with :func:`hmc_transition`: the counterpart of the
    reference's ``jax.vmap(_single_chain)``, run as one batch (no loop over
    chains). logp and grad are ``vmap(logprob)`` and ``vmap(grad(logprob))``.

    ``u0s``: (C, dim). Phase keys as :func:`_pooled_chains`'s; each phase's
    draws are segments of :func:`_phase_randoms`, or the rows of ``draws``
    (one (z, jit, u01) per phase, as there; interop.chain_phase_draws
    carries the reference's per-chain draws). ``offset`` is the first
    chain's global index (a shard's chains draw by it). Returns (us,
    logps, aprobs, divs) as (chains, samples, ...), eps (chains,) and
    inv_mass (chains, dim).
    """
    from modppl_tpu_torch.inference.adaptation import run_warmup

    logp = torch.func.vmap(logprob)
    grad = torch.func.vmap(torch.func.grad(logprob))
    phase_draws = _phase_draws(draws, num_warmup)

    def warm_transition(x, us, eps, inv_mass):
        us, _, aprob, _ = hmc_transition(None, us, logp, grad, eps,
                                         num_leapfrog, inv_mass, draws=x)
        return us, aprob

    us, eps, inv_mass = run_warmup(
        fold_in(key, 0), u0s, warm_transition, num_warmup, eps0,
        target_accept,
        phase_inputs=lambda phase, phase_key, length: _phase_steps(
            phase_key, length, u0s, next(phase_draws), offset))
    ys = []
    for x in _phase_steps(fold_in(key, 2), num_samples, u0s,
                          next(phase_draws), offset):
        us, lp, aprob, div = hmc_transition(None, us, logp, grad, eps,
                                            num_leapfrog, inv_mass, draws=x)
        ys.append((us, lp, aprob, div))
    return (*_stack_samples(ys), eps, inv_mass)


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def hmc_runner(model, args, observed, *, num_samples=1000, num_warmup=500,
               num_chains=1, step_size=0.1, num_leapfrog=16,
               target_accept=0.8, selection=None, init_trace=None,
               pooled_adaptation=None, axis_name=None,
               use_fused_quadratic=None, setup_key=0, device="cuda"):
    """Build a reusable HMC sampler: returns ``run(key) -> dict``.

    Set-up (initial trace, bijectors, quadratic-target detection) happens
    once, here; each ``run(key)`` draws the chains' start points and runs
    the chains. Everything runs on ``device`` (the card unless the caller
    passes ``device="cpu"``): tensor arguments and observations are moved
    there. Keys are the port's integer keys (core/keys.py).

    A quadratic target takes the chunk kernels (``use_fused_quadratic``:
    None detects it when ``num_warmup >= 1``, True requires it, False never
    takes it); every other run takes the generic path, with one shared
    adapted (eps, inv_mass) when ``pooled_adaptation`` (default: more than
    one chain) and one per chain otherwise.

    ``axis_name`` names a mesh axis (parallel/mesh.py) to shard the chains
    over: each rank builds the runner alike and calls ``run`` inside the
    mesh (``with mesh:``); ``num_chains`` is the total, each shard runs its
    ``num_chains / shards`` chains (chain i keyed by its global index, as
    one device keys it) on its shard device, and the pooled adaptation
    sums over every shard's chains. Returned per-chain values are the
    shard's; eps and inv_mass are replicated. The fused quadratic path
    does not pool across shards, so ``use_fused_quadratic=True`` with
    ``axis_name`` raises and detection is off.
    """
    if use_fused_quadratic and axis_name is not None:
        raise ValueError(
            "use_fused_quadratic=True cannot be combined with axis_name: "
            "the fused quadratic path does not pool adaptation across "
            "shards (use the generic pooled path)")
    if axis_name is not None:
        from modppl_tpu_torch.parallel.mesh import shard_device

        device = shard_device(device)
    device, args, observed = entry_inputs(device, args, observed,
                                          "hmc_runner")
    if init_trace is None:
        init_trace, _ = model.generate(setup_key, args, observed,
                                       device=device)
    target = flat_target(model, args, init_trace, observed, selection,
                         device=device)
    logprob_flat, u0_flat = target.logprob, target.u0
    dim = u0_flat.shape[0]
    if pooled_adaptation is None:
        pooled_adaptation = num_chains > 1

    quad = None
    # automatic dispatch needs num_warmup >= 1 (a zero-length warmup kernel
    # cannot launch) and otherwise takes the generic path; an explicit
    # use_fused_quadratic=True always detects, and _quadratic_chains raises
    # on num_warmup=0, as the reference does
    if use_fused_quadratic or (use_fused_quadratic is None
                               and axis_name is None and num_warmup >= 1):
        quad = detect_quadratic_target(logprob_flat, dim, u0_flat.dtype,
                                       device)
        if quad is None and use_fused_quadratic:
            raise ValueError(
                "use_fused_quadratic=True but the target's log-density is "
                "not quadratic in the unconstrained latents")

    @annotate("modppl.hmc.run")
    def run(k_run):
        c_local, offset = shard_chains(num_chains, axis_name)
        # overdispersed start points around the initial trace
        u0s = start_points(k_run, u0_flat, c_local, offset)
        if quad is None and pooled_adaptation:
            us, logps, aprobs, divs, eps, inv_mass = _pooled_chains(
                fold_in(k_run, 0), logprob_flat, u0s, num_warmup,
                num_samples, step_size, num_leapfrog, target_accept,
                axis_name=axis_name)
        elif quad is None:
            us, logps, aprobs, divs, eps, inv_mass = _single_chain(
                fold_in(k_run, 0), logprob_flat, u0s, num_warmup,
                num_samples, step_size, num_leapfrog, target_accept,
                offset=offset)
        if quad is None:
            dev = u0s.new_zeros(())
            quad_ok = torch.ones((), dtype=torch.bool, device=device)
        else:
            us, logps, aprobs, divs, eps, inv_mass = _quadratic_chains(
                fold_in(k_run, 0), *quad, u0s, num_warmup, num_samples,
                step_size, num_leapfrog, target_accept)
            with annotate("modppl.hmc.check"):
                dev, quad_ok = _quad_check(logprob_flat, us, logps)
        return {
            "samples": target.constrain(us),
            "logp": logps,
            "accept_prob": aprobs,
            "divergences": divs,
            "step_size": eps,
            # adapted diagonal metric M^-1 (Stan's inv_metric): (dim,)
            # shared by all chains under pooled adaptation and on the fused
            # path, (chains, dim) on the per-chain path
            "inv_mass": inv_mass,
            "unconstrained": us,
            # which transition ran
            "fused_quadratic": quad is not None,
            # the fused path's self-check; trivially True on the generic
            # path
            "quad_check_ok": quad_ok,
            "quad_check_max_dev": dev,
        }

    # the detected (Λ, b), for a caller that runs fixed-step HMC
    # (ops/leapfrog.hmc_quadratic) on the same target after this warmup
    run.quadratic = quad
    return run


def shard_chains(num_chains, axis_name=None):
    """(this shard's chain count, its first global index) of
    ``num_chains`` over the shards of ``axis_name`` (None: all, from 0).
    The chains must divide over the shards."""
    if axis_name is None:
        return num_chains, 0
    from modppl_tpu_torch.parallel.collectives import axis_index, axis_size

    size = axis_size(axis_name)
    if num_chains % size:
        raise ValueError(f"num_chains {num_chains} not divisible by "
                         f"{axis_name}={size}")
    c_local = num_chains // size
    return c_local, c_local * axis_index(axis_name)


def _quad_check(logprob_flat, us, logps):
    """Self-check of the fused dispatch: re-score a few final draws through
    the generic log-joint; the difference from the kernels' logp must be
    the constant the quadratic form drops. Returns (max deviation, ok)."""
    num_chains, num_samples, dim = us.shape
    k_chk, t_chk = min(num_chains, 8), min(num_samples, 2)
    us_k = us[:k_chk, -t_chk:, :].reshape(-1, dim)
    lp_k = logps[:k_chk, -t_chk:].reshape(-1)
    with torch.no_grad():
        gen_lp = torch.stack([torch.as_tensor(logprob_flat(x)) for x in us_k])
    diff = gen_lp - lp_k
    dev = torch.max(torch.abs(diff - diff[0]))
    spread = torch.max(torch.abs(lp_k - lp_k[0]))
    return dev, dev <= 5e-3 * (1.0 + spread)


def hmc(key, model, args, observed, **config):
    """Run adaptive HMC; returns samples in constrained space and
    diagnostics. Samples: {addr: (chains, num_samples) + value_shape}."""
    k_init, k_run = split(key)
    run = hmc_runner(model, args, observed, setup_key=k_init, **config)
    return run(k_run)
