"""Variational inference: mean-field and full-rank ADVI (counterpart of
modppl_tpu/inference/vi.py).

The ELBO is built on the unconstrained log-joint that HMC uses
(inference/hmc.make_unconstrained_logprob); the variational family is a
Gaussian in unconstrained space, diagonal (:func:`advi`) or full-rank
Cholesky (:func:`advi_fullrank`). Each optimization step is ONE
``torch.func.grad_and_value`` of the negative ELBO, whose expectation is a
``vmap`` of the log-joint over the step's Monte Carlo draws, then one Adam
step (inference/_adam.py: optax's update under
``optax.exponential_decay(lr, num_steps, 1/30)``). The loop over steps
runs on the host and reads nothing back: the ELBO trace stays on the
device.

Entry points run on ``device``: the card unless the caller passes
``device="cpu"``; tensor arguments and observations are moved there.
``draws`` replaces the steps' random numbers (the tests hand both packages
the same ones).
"""

import math

import torch

from modppl_tpu_torch.core.keys import fold_in, generator, split
from modppl_tpu_torch.inference._adam import (
    adam_init,
    adam_step,
    exponential_decay,
)
from modppl_tpu_torch.inference.hmc import (
    flat_target,
    make_unconstrained_logprob,
    ravel_latents,
)
from modppl_tpu_torch.modeling.handlers import entry_inputs


def _minibatch_logprob(model, args, observed, selection, minibatch,
                       setup_key, init_trace, device):
    """The data-subsampled unconstrained log-joint ``logprob(u, idx)``.

    ``minibatch = (num_data, batch_size)``: the model is called with
    ``args + (idx,)``, ``idx`` a (batch_size,) row-index vector. The MODEL
    owns the scaling: it indexes its observations by ``idx`` and scales the
    batch log-likelihood factor by ``num_data / batch_size``, which, with
    indices drawn uniformly WITH replacement, is exactly unbiased for the
    full-data log-likelihood. The initial trace is generated at ``idx =
    arange(batch_size) % num_data`` unless ``init_trace`` is given.
    """
    num_data, batch_size = minibatch
    idx0 = torch.arange(batch_size, device=device) % num_data
    if init_trace is None:
        init_trace, _ = model.generate(setup_key, args + (idx0,), observed,
                                       device=device)
    _, u0, bijectors, constrain = make_unconstrained_logprob(
        model, args + (idx0,), init_trace, observed, selection,
        device=device)

    def logprob_idx(u, idx):
        constraints = observed.copy()
        ldj = 0.0
        for addr, bij in bijectors.items():
            constraints.observe(addr, bij.forward(u[addr]))
            ldj = ldj + bij.log_det_jacobian(u[addr])
        return model.assess(0, args + (idx,), constraints,
                            device=device) + ldj

    return logprob_idx, u0, bijectors, constrain


def _step_draws(k_opt, num_steps, num_mc, dim, dtype, device,
                minibatch=None, draws=None):
    """Each step's (eps (num_mc, dim), idx (batch_size,) or None): the rows
    of ``draws`` = (eps (T, num_mc, dim), idx (T, batch_size) or None), else
    one generator keyed ``k_opt`` for the normals and one keyed
    ``fold_in(k_opt, 1)`` for the indices, drawn step by step."""
    if draws is not None:
        eps, idx = draws
        if tuple(eps.shape) != (num_steps, num_mc, dim):
            raise ValueError(f"draws: eps of shape {(num_steps, num_mc, dim)}"
                             f" expected, got {tuple(eps.shape)}")
        for t in range(num_steps):
            yield eps[t], None if idx is None else idx[t]
        return
    g = generator(k_opt, device)
    g_idx = generator(fold_in(k_opt, 1), device) if minibatch else None
    for _ in range(num_steps):
        eps = torch.randn((num_mc, dim), generator=g, dtype=dtype,
                          device=device)
        idx = (torch.randint(minibatch[0], (minibatch[1],), generator=g_idx,
                             device=device) if minibatch else None)
        yield eps, idx


def _optimize(neg_elbo, params, num_steps, learning_rate, steps):
    """Adam on ``neg_elbo(params, eps, idx)`` over ``steps``; returns the
    final params and the ELBO trace (num_steps,)."""
    grad_fn = torch.func.grad_and_value(neg_elbo)
    # decay the step size 30x over the run: averages out the Monte Carlo
    # gradient noise so the mean parameters settle instead of oscillating
    schedule = exponential_decay(learning_rate, max(num_steps, 1), 1.0 / 30.0)
    state = adam_init(params)
    elbos = []
    for eps, idx in steps:
        grads, loss = grad_fn(params, eps, idx)
        params, state = adam_step(params, grads, state, schedule)
        elbos.append(-loss)
    return params, torch.stack(elbos) if elbos else params[0].new_zeros(0)


def advi(key, model, args, observed, *, num_steps=2000, num_mc=8,
         learning_rate=1e-2, selection=None, init_trace=None,
         minibatch=None, device=None, draws=None):
    """Mean-field ADVI. Returns a dict: ``mu`` and ``log_sigma`` (the
    variational parameters, unconstrained), ``elbo`` (num_steps,),
    ``sample(key, num)`` (constrained draws, an {addr: value} dict with a
    leading axis num), ``bijectors`` and ``unravel``.

    ELBO(mu, log_sigma) = E_{z~q}[logp(z)] + H[q], with H[q] = 0.5 d (1 +
    log 2 pi) + sum log sigma; q starts at the initial trace's values with
    log sigma = -2. ``minibatch=(num_data, batch_size)`` subsamples the
    data: each step draws a fresh (batch_size,) index vector uniformly
    with replacement and calls the model with ``args + (idx,)`` (see
    ``_minibatch_logprob`` and models/logreg.make_logreg_minibatch).
    ``draws`` = (eps (num_steps, num_mc, d), idx (num_steps, batch_size)
    or None) replaces the steps' random numbers.
    """
    device, args, observed = entry_inputs(device, args, observed, "advi")
    k_init, k_opt = split(key)
    if minibatch is not None:
        logprob_idx, u0, bijectors, constrain = _minibatch_logprob(
            model, args, observed, selection, minibatch, k_init, init_trace,
            device)
    else:
        if init_trace is None:
            init_trace, _ = model.generate(k_init, args, observed,
                                           device=device)
        logprob, u0, bijectors, constrain = make_unconstrained_logprob(
            model, args, init_trace, observed, selection, device=device)
        logprob_idx = lambda u, idx: logprob(u)  # noqa: E731
    u0_flat, unravel = ravel_latents(u0)
    u0_flat = u0_flat.to(device)
    dim = u0_flat.shape[0]
    entropy0 = 0.5 * dim * (1.0 + math.log(2.0 * math.pi))

    def neg_elbo(params, eps, idx):
        mu, log_sigma = params
        zs = mu[None, :] + torch.exp(log_sigma)[None, :] * eps
        e_logp = torch.mean(torch.func.vmap(
            lambda z: logprob_idx(unravel(z), idx))(zs))
        return -(e_logp + (entropy0 + torch.sum(log_sigma)))

    params = (u0_flat, torch.full((dim,), -2.0, dtype=u0_flat.dtype,
                                  device=device))
    (mu, log_sigma), elbos = _optimize(
        neg_elbo, params, num_steps, learning_rate,
        _step_draws(k_opt, num_steps, num_mc, dim, u0_flat.dtype, device,
                    minibatch, draws))

    def sample(k, num):
        eps = torch.randn((num, dim), generator=generator(k, device),
                          dtype=mu.dtype, device=device)
        return constrain(unravel(mu[None, :] + torch.exp(log_sigma)[None, :]
                                 * eps))

    return {"mu": mu, "log_sigma": log_sigma, "elbo": elbos,
            "sample": sample, "bijectors": bijectors, "unravel": unravel}


def advi_fullrank(key, model, args, observed, *, num_steps=2000, num_mc=8,
                  learning_rate=1e-2, selection=None, init_trace=None,
                  device=None, draws=None):
    """Full-rank ADVI: q = N(mu, L L^T) with L a learned Cholesky factor
    (the strictly lower entries free, the diagonal through exp), which
    captures posterior correlations mean-field cannot. Entropy H[q] = 0.5 d
    (1 + log 2 pi) + sum log diag(L). Returns :func:`advi`'s interface with
    ``chol`` (the learned L) in place of ``log_sigma``; ``draws`` = (eps
    (num_steps, num_mc, d), None)."""
    device, args, observed = entry_inputs(device, args, observed,
                                          "advi_fullrank")
    k_init, k_opt = split(key)
    if init_trace is None:
        init_trace, _ = model.generate(k_init, args, observed, device=device)
    logprob, u0_flat, constrain, unravel, bijectors = flat_target(
        model, args, init_trace, observed, selection, device=device)
    dim = u0_flat.shape[0]
    il, jl = torch.tril_indices(dim, dim, device=device)
    entropy0 = 0.5 * dim * (1.0 + math.log(2.0 * math.pi))

    def build_chol(params_l):
        L = params_l.new_zeros((dim, dim)).index_put((il, jl), params_l)
        d = torch.diagonal(L)
        return L - torch.diag(d) + torch.diag(torch.exp(d))

    def neg_elbo(params, eps, _idx):
        mu, params_l = params
        L = build_chol(params_l)
        zs = mu[None, :] + eps @ L.T
        e_logp = torch.mean(torch.func.vmap(logprob)(zs))
        return -(e_logp + (entropy0
                           + torch.sum(torch.log(torch.diagonal(L)))))

    params_l0 = torch.where(il == jl, -2.0, 0.0).to(u0_flat.dtype)
    (mu, params_l), elbos = _optimize(
        neg_elbo, (u0_flat, params_l0), num_steps, learning_rate,
        _step_draws(k_opt, num_steps, num_mc, dim, u0_flat.dtype, device,
                    draws=draws))
    L = build_chol(params_l)

    def sample(k, num):
        eps = torch.randn((num, dim), generator=generator(k, device),
                          dtype=mu.dtype, device=device)
        return constrain(mu[None, :] + eps @ L.T)

    return {"mu": mu, "chol": L, "elbo": elbos, "sample": sample,
            "bijectors": bijectors, "unravel": unravel}
