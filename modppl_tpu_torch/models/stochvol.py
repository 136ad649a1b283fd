"""Stochastic volatility state-space model (counterpart of
modppl_tpu/models/stochvol.py).

    h_0 ~ N(mu, sigma / sqrt(1 - phi^2))
    h_t = mu + phi (h_{t-1} - mu) + sigma eps_t
    y_t ~ N(0, beta exp(h_t / 2))

The latent log-volatility h drives the observation scale, so the weights
are heavy-tailed and resampling fires often. ``sv_scan_kernel`` is an
ordinary per-particle (init, step) pair for either filter tier;
``make_stochvol_joint`` is the whole-path form for gradient inference.
The reference's in-model ``lax.scan`` is a loop over T of tensor ops here,
in the reference's order of operations, over any leading lane axes.
"""

import math
from dataclasses import dataclass

import torch

from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.dists.iid import iid
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.handlers import entry_device


@dataclass(frozen=True)
class SVParams:
    mu: float = -1.0      # long-run mean log-volatility
    phi: float = 0.97     # persistence
    sigma: float = 0.15   # vol-of-vol
    beta: float = 1.0     # scale


def _sd0(params):
    """The stationary sd of h_0, sigma / sqrt(1 - phi^2)."""
    return params.sigma / math.sqrt(1.0 - params.phi * params.phi)


def sv_scan_kernel(params: SVParams = SVParams()):
    """Per-particle (init, step) pair (vmapped or auto-batched tiers)."""
    from modppl_tpu_torch.inference.vsmc import ScanKernel

    mu, phi, sigma, beta = params.mu, params.phi, params.sigma, params.beta
    sd0 = _sd0(params)

    @gen
    def sv_init(h, _state0):
        hv = h.sample(normal, (mu, sd0), "h")
        h.sample(normal, (0.0, beta * torch.exp(hv / 2.0)), "y")
        return hv

    @gen
    def sv_step(h, t, prev):
        hv = h.sample(normal, (mu + phi * (prev - mu), sigma), "h")
        h.sample(normal, (0.0, beta * torch.exp(hv / 2.0)), "y")
        return hv

    return ScanKernel(sv_init, sv_step)


def volatility_path(z, params: SVParams = SVParams()):
    """Innovations z (..., T) -> the log-volatility path h (..., T), the
    transform ``sv_joint`` applies."""
    mu, phi, sigma = params.mu, params.phi, params.sigma
    h = mu + _sd0(params) * z[..., 0]
    hs = [h]
    for t in range(1, z.shape[-1]):
        h = mu + phi * (h - mu) + sigma * z[..., t]
        hs.append(h)
    return torch.stack(hs, dim=-1)


def make_stochvol_joint(T, params: SVParams = SVParams()):
    """Joint (whole-path) form for gradient inference, non-centered: the
    latent address ``z`` is the (T,) vector of standard-normal innovations
    (one ``iid`` plate), the path is ``volatility_path(z)`` and the
    observations enter through one ``factor``."""
    beta = params.beta
    z_dist = iid(normal, T)

    @gen
    def sv_joint(h, ys):
        z = h.sample(z_dist, (0.0, 1.0), "z")
        hv = volatility_path(z, params)
        ll = torch.sum(normal.logpdf(ys, (0.0, beta * torch.exp(hv / 2.0))),
                       dim=-1)
        h.factor(ll, "lik")
        return hv

    return sv_joint


def simulate_sv(key, T, params: SVParams = SVParams(), device=None,
                draws=None):
    """A ground-truth (h, y) path, on the card unless ``device`` names
    another: ``eps`` and ``eta`` are T standard normals each from the keys
    ``split(key)`` (the reference's layout; its numbers differ), or
    ``draws=(eps, eta)``."""
    device = entry_device(device, "simulate_sv")
    mu, phi, sigma, beta = params.mu, params.phi, params.sigma, params.beta
    if draws is None:
        k1, k2 = split(key)
        dtype = torch.get_default_dtype()
        eps, eta = (torch.randn(T, generator=generator(k, device),
                                dtype=dtype, device=device) for k in (k1, k2))
    else:
        eps, eta = (torch.as_tensor(x, device=device) for x in draws)
    h = mu + _sd0(params) * eps[0]
    hs, ys = [h], [beta * torch.exp(h / 2.0) * eta[0]]
    for t in range(1, T):
        h = mu + phi * (h - mu) + sigma * eps[t]
        hs.append(h)
        ys.append(beta * torch.exp(h / 2.0) * eta[t])
    return torch.stack(hs), torch.stack(ys)
