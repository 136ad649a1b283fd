"""Hamiltonian Monte Carlo with pooled dual-averaging step size and diagonal
mass adaptation (counterpart of modppl_tpu/inference/hmc.py).

The port's path so far is the quadratic one: ``hmc_runner`` builds the
latent log-density over unconstrained space from the model's ``assess``
(bijectors per address from the trie's recorded distributions), detects a
quadratic target (logp = b.u - u.Λu/2 + const: every all-Gaussian model
with identity bijectors) and runs the whole pooled warmup and the whole
sampling phase as one kernel launch each (``_quadratic_chains``): the
ops/leapfrog_small.py kernels at d <= 12, the ops/leapfrog.py kernels
above. The generic paths (pooled generic transitions, per-chain chains)
are not ported yet and raise.
"""

import numpy as np
import torch

from modppl_tpu_torch.core.keys import fold_in, generator, split
from modppl_tpu_torch.inference.transforms import transform_for

GENERIC_PATH_TODO = ("not ported yet (ROADMAP Queue 1 item 10a: the "
                     "generic pooled HMC path, _pooled_chains / "
                     "_single_chain)")

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

        us, eps, inv_mass = hmc_warmup_chunk_small(
            fold_in(key, 0), u0s, float(eps0), lam, b, num_warmup,
            num_leapfrog, target_accept=target_accept, draws=warm)
        us_t, logps, aprobs, divs, _ = hmc_sample_chunk_small(
            fold_in(key, 2), us, eps, lam, b, inv_mass, num_samples,
            num_leapfrog, draws=samp)
    else:
        from modppl_tpu_torch.ops.leapfrog import (
            hmc_sample_chunk,
            hmc_warmup_chunk,
        )

        us, eps, inv_mass = hmc_warmup_chunk(
            fold_in(key, 0), u0s, float(eps0), lam, b, num_warmup,
            num_leapfrog, target_accept=target_accept, draws=warm)
        us_t, logps, aprobs, divs = hmc_sample_chunk(
            fold_in(key, 2), us, eps, lam, b, inv_mass, num_samples,
            num_leapfrog, draws=samp)
    # (samples, chains, ...) -> (chains, samples, ...)
    return (*(x.transpose(0, 1) for x in (us_t, logps, aprobs, divs)), eps,
            inv_mass)


def _pooled_chains(*args, **kwargs):
    raise NotImplementedError(f"hmc: the generic pooled path is "
                              f"{GENERIC_PATH_TODO}")


def _single_chain(*args, **kwargs):
    raise NotImplementedError(f"hmc: the per-chain path is "
                              f"{GENERIC_PATH_TODO}")


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def _to_device(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, device) for v in x)
    return x


def hmc_runner(model, args, observed, *, num_samples=1000, num_warmup=500,
               num_chains=1, step_size=0.1, num_leapfrog=16,
               target_accept=0.8, selection=None, init_trace=None,
               use_fused_quadratic=None, setup_key=0, device="cuda"):
    """Build a reusable HMC sampler: returns ``run(key) -> dict``.

    Set-up (initial trace, bijectors, quadratic-target detection) happens
    once, here; each ``run(key)`` draws the chains' start points and runs
    the kernels. Everything runs on ``device`` (the card unless the caller
    passes ``device="cpu"``): tensor arguments and observations are moved
    there. Keys are the port's integer keys (core/keys.py).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hmc_runner: device='cuda' but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    args = _to_device(args if isinstance(args, tuple) else (args,), device)
    observed = observed.map(lambda v: _to_device(v, device))
    if init_trace is None:
        init_trace, _ = model.generate(setup_key, args, observed,
                                       device=device)
    logprob, u0, _, constrain = make_unconstrained_logprob(
        model, args, init_trace, observed, selection, device=device)
    u0_flat, unravel = ravel_latents(u0)
    u0_flat = u0_flat.to(device)
    dim = u0_flat.shape[0]

    def logprob_flat(u_flat):
        return logprob(unravel(u_flat))

    quad = None
    # automatic dispatch needs num_warmup >= 1 (a zero-length warmup kernel
    # cannot launch); an explicit use_fused_quadratic=True always detects,
    # and _quadratic_chains raises on num_warmup=0, as the reference does
    if use_fused_quadratic or (use_fused_quadratic is None
                               and num_warmup >= 1):
        quad = detect_quadratic_target(logprob_flat, dim, u0_flat.dtype,
                                       device)
        if quad is None and use_fused_quadratic:
            raise ValueError(
                "use_fused_quadratic=True but the target's log-density is "
                "not quadratic in the unconstrained latents")
    if quad is None:
        # a non-quadratic target, use_fused_quadratic=False or automatic
        # dispatch with num_warmup=0
        (_pooled_chains if num_chains > 1 else _single_chain)()

    def run(k_run):
        k_chains, _ = split(k_run)
        # overdispersed start points around the initial trace
        jitter = 0.5 * torch.randn((num_chains, dim),
                                   generator=generator(k_chains, device),
                                   dtype=u0_flat.dtype, device=device)
        u0s = u0_flat[None, :] + jitter
        lam, b = quad
        us, logps, aprobs, divs, eps, inv_mass = _quadratic_chains(
            fold_in(k_run, 0), lam, b, u0s, num_warmup, num_samples,
            step_size, num_leapfrog, target_accept)
        # self-check of the dispatch: re-score a few final draws through the
        # generic log-joint; the difference must be the constant the
        # quadratic form drops
        k_chk, t_chk = min(num_chains, 8), min(num_samples, 2)
        us_k = us[:k_chk, -t_chk:, :].reshape(-1, dim)
        lp_k = logps[:k_chk, -t_chk:].reshape(-1)
        with torch.no_grad():
            gen_lp = torch.stack([torch.as_tensor(logprob_flat(x))
                                  for x in us_k])
        diff = gen_lp - lp_k
        dev = torch.max(torch.abs(diff - diff[0]))
        spread = torch.max(torch.abs(lp_k - lp_k[0]))
        quad_ok = dev <= 5e-3 * (1.0 + spread)
        samples = constrain(unravel(us))
        return {
            "samples": samples,
            "logp": logps,
            "accept_prob": aprobs,
            "divergences": divs,
            "step_size": eps,
            # adapted diagonal metric M^-1 (Stan's inv_metric), shared by
            # all chains: (dim,)
            "inv_mass": inv_mass,
            "unconstrained": us,
            "fused_quadratic": True,
            "quad_check_ok": quad_ok,
            "quad_check_max_dev": dev,
        }

    # the detected (Λ, b), for a caller that runs fixed-step HMC
    # (ops/leapfrog.hmc_quadratic) on the same target after this warmup
    run.quadratic = quad
    return run


def hmc(key, model, args, observed, **config):
    """Run adaptive HMC; returns samples in constrained space and
    diagnostics. Samples: {addr: (chains, num_samples) + value_shape}."""
    k_init, k_run = split(key)
    run = hmc_runner(model, args, observed, setup_key=k_init, **config)
    return run(k_run)
