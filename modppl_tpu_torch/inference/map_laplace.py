"""MAP estimation and the Laplace approximation (counterpart of
modppl_tpu/inference/map_laplace.py).

Both run on the unconstrained log-joint that HMC and VI use
(inference/hmc.make_unconstrained_logprob). ``num_restarts`` jittered
starts are one (R, d) tensor: each Adam step is ONE batched
``vmap(grad_and_value)`` call over the restarts and one elementwise
update (inference/_adam.py, optax's formula), not a loop over restarts.
The Laplace curvature is ``torch.func.hessian`` of the objective at the
mode.

Conventions (as Stan's):

- ``map_optimize`` maximizes the joint density in CONSTRAINED space by
  default (``jacobian=False``): the mode of the model's own
  parameterization. ``jacobian=True`` maximizes the Jacobian-adjusted
  unconstrained density (the mode of what HMC targets).
- ``laplace_approximation`` always uses the Jacobian-adjusted density: a
  Gaussian in unconstrained coordinates, whose log-normalizer estimates
  the log marginal likelihood, log Z ~= logp(u*) + d/2 log(2 pi) + 1/2 log
  det Sigma.

Entry points run on ``device``: the card unless the caller passes
``device="cpu"``; tensor arguments and observations are moved there.
"""

import math

import torch

from modppl_tpu_torch.core.keys import generator
from modppl_tpu_torch.inference._adam import adam_init, adam_step
from modppl_tpu_torch.inference.hmc import _value_and_grad, flat_target
from modppl_tpu_torch.modeling.handlers import entry_inputs


def _setup(model, args, observed, init_trace, setup_key, device, what):
    device, args, observed = entry_inputs(device, args, observed, what)
    if init_trace is None:
        init_trace, _ = model.generate(setup_key, args, observed,
                                       device=device)
    return device, args, observed, init_trace


def _adam_restarts(objective, inits, num_steps, learning_rate):
    """``num_steps`` Adam steps of gradient ascent on ``objective`` from
    each row of ``inits`` (R, d) at once. Returns (us (R, d), objective at
    each)."""
    vag = _value_and_grad(objective)
    us, state = (inits,), adam_init((inits,))
    for _ in range(num_steps):
        _, g = vag(us[0])
        us, state = adam_step(us, (-g,), state, learning_rate)  # ascent
    return us[0], torch.func.vmap(objective)(us[0])


def map_optimize(key, model, args, observed, *, num_steps=500,
                 learning_rate=0.05, num_restarts=8, init_jitter=1.0,
                 jacobian=False, selection=None, init_trace=None,
                 setup_key=0, device=None):
    """Posterior mode by multi-start Adam on the unconstrained log-joint.

    Restart 0 starts at the initial trace's values, the others at those
    plus ``init_jitter`` standard normals (drawn from ``key``). Returns a
    dict: ``params`` ({addr: value} at the best mode, constrained),
    ``unconstrained`` (the flat optimum), ``logp`` (the objective there;
    without the Jacobian term unless ``jacobian=True``) and
    ``restart_logps`` (num_restarts,) (distinct values: distinct local
    modes). A restart that ends non-finite never wins.
    """
    device, args, observed, init_trace = _setup(
        model, args, observed, init_trace, setup_key, device, "map_optimize")
    # the log-det-Jacobian term only with jacobian=True (constrained-space
    # MAP leaves it out)
    objective, u0_flat, constrain_flat, _, _ = flat_target(
        model, args, init_trace, observed, selection, jacobian, device)
    jitter = init_jitter * torch.randn(
        (num_restarts,) + tuple(u0_flat.shape),
        generator=generator(key, device), dtype=u0_flat.dtype, device=device)
    inits = u0_flat[None, :] + jitter
    inits[0] = u0_flat
    us, vals = _adam_restarts(objective, inits, num_steps, learning_rate)
    best = torch.argmax(torch.where(torch.isfinite(vals), vals, -math.inf))
    return {
        "params": constrain_flat(us[best]),
        "unconstrained": us[best],
        "logp": vals[best],
        "restart_logps": vals,
    }


def _laplace_at(objective, u_star, logp):
    """(cov, chol, log_ml) of the Gaussian at the mode ``u_star`` of
    ``objective``, whose value there is ``logp``. Raises ``ValueError``
    when the Hessian is not negative-definite (one host read)."""
    d = u_star.shape[0]
    H = torch.func.hessian(objective)(u_star)
    H = 0.5 * (H + H.T)
    # cov = (-H)^-1 through a Cholesky of the precision
    L_prec, info = torch.linalg.cholesky_ex(-H)
    if int(info) != 0 or not bool(torch.isfinite(L_prec).all()):
        raise ValueError(
            "laplace_approximation: the Hessian at the optimum is not "
            "negative-definite (saddle point, flat direction, or "
            "under-converged optimization; try more num_steps or a smaller "
            "learning_rate)")
    eye = torch.eye(d, dtype=u_star.dtype, device=u_star.device)
    Linv = torch.linalg.solve_triangular(L_prec, eye, upper=False)
    cov = Linv.T @ Linv
    chol = torch.linalg.cholesky(cov)
    logdet_cov = -2.0 * torch.sum(torch.log(torch.diagonal(L_prec)))
    log_ml = logp + 0.5 * d * math.log(2.0 * math.pi) + 0.5 * logdet_cov
    return cov, chol, log_ml


def laplace_approximation(key, model, args, observed, *, num_steps=500,
                          learning_rate=0.05, num_restarts=8,
                          init_jitter=1.0, selection=None, init_trace=None,
                          setup_key=0, device=None):
    """Gaussian (Laplace) posterior approximation in unconstrained space.

    The mode of the Jacobian-adjusted log-joint (:func:`map_optimize` with
    ``jacobian=True``), curved by the exact Hessian. Returns a dict:
    ``mean`` / ``cov`` / ``chol`` (the Gaussian, unconstrained), ``log_ml``
    (the Laplace estimate of the log marginal likelihood), ``logp`` (the
    log-joint at the mode), ``params`` ({addr: value} at the mode,
    constrained), ``restart_logps`` and ``sample(key, n)``, which draws n
    samples as an {addr: value} dict in constrained space (leading axis n).
    A Hessian that is not negative-definite raises ``ValueError``.
    """
    device, args, observed, init_trace = _setup(
        model, args, observed, init_trace, setup_key, device,
        "laplace_approximation")
    objective, _, constrain_flat, _, _ = flat_target(
        model, args, init_trace, observed, selection, True, device)
    out = map_optimize(key, model, args, observed, num_steps=num_steps,
                       learning_rate=learning_rate,
                       num_restarts=num_restarts, init_jitter=init_jitter,
                       jacobian=True, selection=selection,
                       init_trace=init_trace, device=device)
    u_star = out["unconstrained"]
    cov, chol, log_ml = _laplace_at(objective, u_star, out["logp"])

    def sample(k, n):
        z = torch.randn((n, u_star.shape[0]), generator=generator(k, device),
                        dtype=u_star.dtype, device=device)
        return constrain_flat(u_star[None, :] + z @ chol.T)

    return {
        "mean": u_star,
        "cov": cov,
        "chol": chol,
        "log_ml": log_ml,
        "logp": out["logp"],
        "params": constrain_flat(u_star),
        "restart_logps": out["restart_logps"],
        "sample": sample,
    }
