"""Gaussian-process regression with hyperparameter inference (counterpart
of modppl_tpu/models/gp.py).

A squared-exponential GP prior over function values at a fixed input grid,
with log-scale hyperparameters (amplitude, length scale, observation noise)
as latents. The marginal likelihood is not quadratic in the log
hyperparameters, so HMC takes the generic path, and MAP / Laplace give the
empirical-Bayes point estimate. The marginal ``y ~ N(0, K + (sigma^2 +
jitter) I)`` is one ``mvnormal`` address, factored by its unrolled Cholesky
for n <= 32 points.

The inputs are float32 as in the reference; the covariance follows the
latents' dtype (float64 latents give a float64 covariance, as the
reference's do under x64).
"""

import torch

from modppl_tpu_torch.dists import mvnormal, normal
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.handlers import entry_device
from modppl_tpu_torch.ops.smalllinalg import solve_psd_small


def rbf_kernel(xs1, xs2, amp, length_scale):
    """Squared-exponential kernel matrix amp^2 exp(-d^2 / (2 ls^2))."""
    d2 = (xs1[:, None] - xs2[None, :]) ** 2
    return amp * amp * torch.exp(-0.5 * d2 / (length_scale * length_scale))


def _device(xs, device, what):
    """``device``, else ``xs``'s own when it is a tensor, else the card."""
    if device is None and torch.is_tensor(xs):
        device = xs.device
    return entry_device(device, what)


def make_gp_model(xs, jitter=1e-6, device=None):
    """GP regression model over the fixed input grid ``xs`` (float32, on
    ``device``: ``xs``'s own when it is a tensor, else the card unless the
    caller names one). Latents ``log_amp`` ~ N(0, 1), ``log_ls`` ~ N(0, 1),
    ``log_noise`` ~ N(-2, 1); observed ``y`` (n,)."""
    xs = torch.as_tensor(xs, dtype=torch.float32).to(
        _device(xs, device, "make_gp_model"))
    n = xs.shape[0]
    d2 = (xs[:, None] - xs[None, :]) ** 2
    eye = torch.eye(n, dtype=xs.dtype, device=xs.device)

    def scale(v):
        return torch.exp(2.0 * torch.as_tensor(v, device=xs.device))

    @gen
    def gp_model(h):
        amp2 = scale(h.sample(normal, (0.0, 1.0), "log_amp"))
        ls2 = scale(h.sample(normal, (0.0, 1.0), "log_ls"))
        noise2 = scale(h.sample(normal, (-2.0, 1.0), "log_noise"))
        dt = ls2.dtype
        cov = (amp2 * torch.exp(-0.5 * d2.to(dt) / ls2)
               + (noise2 + jitter) * eye.to(dt))
        return h.sample(mvnormal, (torch.zeros(n, dtype=dt, device=xs.device),
                                   cov), "y")

    return gp_model


def gp_posterior_predictive(xs, y, xstar, amp, length_scale, noise,
                            jitter=1e-6, device=None):
    """Closed-form GP posterior mean and variance at ``xstar`` (Rasmussen &
    Williams eq. 2.22-2.24) through the unrolled small solves, on
    ``device`` (``xs``'s own when it is a tensor, else the card unless the
    caller names one), in the inputs' dtype.

    The training covariance carries the model's ``jitter`` beside the
    noise, as ``make_gp_model``'s marginal does, and the variance is
    clamped at 0 (rounding can take K** - K* K^-1 K*^T below it where the
    data pin the function). The reference's predictive omits both.
    """
    device = _device(xs, device, "gp_posterior_predictive")
    xs, y, xstar = (torch.as_tensor(a).to(device) for a in (xs, y, xstar))
    K = (rbf_kernel(xs, xs, amp, length_scale)
         + (noise * noise + jitter)
         * torch.eye(xs.shape[0], dtype=xs.dtype, device=device))
    Ks = rbf_kernel(xstar, xs, amp, length_scale)       # (m, n)
    Kss = rbf_kernel(xstar, xstar, amp, length_scale)   # (m, m)
    alpha = solve_psd_small(K, y[:, None])[:, 0]        # K^-1 y
    mean = Ks @ alpha
    v = solve_psd_small(K, Ks.T)                        # K^-1 Ks^T
    var = torch.clamp(torch.diagonal(Kss - Ks @ v), min=0.0)
    return mean, var
