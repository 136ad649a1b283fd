"""Saturated (static-structure) hierarchical regression (counterpart of
modppl_tpu/models/hierarchical_static.py).

The bernoulli gate is always sampled and its effect on the regression mean
masked with ``where``, so the trace structure is static. Observations are
one plated address "ys". The body runs per trace (under ``vmap`` on the
HMC path) and once over a leading lane axis (the batched tier of
``importance_sampling``). With "is_linear" observed, the continuous
(a, b, c) posterior is Gaussian: the quadratic target the HMC chunk
kernels run. ``make_hierarchical_marginalized`` sums the gate out instead:
a non-quadratic target for the generic HMC path.
"""

import math

import numpy as np
import torch

from modppl_tpu_torch.dists import bernoulli, iid, normal
from modppl_tpu_torch.modeling import gen

NOISE = 0.1


def make_hierarchical_static(n_points):
    """The saturated model for a fixed number of data points; args (xs,)."""
    ys_dist = iid(normal, n_points)

    @gen
    def hierarchical_static(h, xs):
        is_linear = h.sample(bernoulli, 0.7, "is_linear")
        a = h.sample(normal, (0.0, 1.0), "coeffs/a")
        b = h.sample(normal, (0.0, 1.0), "coeffs/b")
        c = h.sample(normal, (0.0, 1.0), "coeffs/c")
        c_eff = torch.where(torch.as_tensor(is_linear, device=xs.device),
                            torch.zeros_like(c), c)
        # the coefficients' trailing unit axis meets the points' axis: (n,)
        # means per trace, (lanes, n) over the batched tier's lanes
        mean = a[..., None] + b[..., None] * xs + c_eff[..., None] * xs * xs
        return h.sample(ys_dist, (mean, NOISE), "ys")

    return hierarchical_static


def exact_hierarchical_posterior(xs, ys, noise=NOISE, p_linear=0.7,
                                 prior_std=(1.0, 1.0, 1.0)):
    """Analytic posterior of the saturated model (numpy, float64).

    Returns (p_linear_post, mean_lin[2], cov_lin, mean_quad[3], cov_quad,
    log_evidence).
    """
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)

    def evidence(design, prior_var):
        n = design.shape[0]
        s = design @ np.diag(prior_var) @ design.T + noise ** 2 * np.eye(n)
        _, logdet = np.linalg.slogdet(2 * np.pi * s)
        log_ev = -0.5 * (logdet + ys @ np.linalg.solve(s, ys))
        post_prec = (np.diag(1.0 / np.asarray(prior_var))
                     + design.T @ design / noise ** 2)
        post_cov = np.linalg.inv(post_prec)
        post_mean = post_cov @ (design.T @ ys) / noise ** 2
        return log_ev, post_mean, post_cov

    X_lin = np.stack([np.ones_like(xs), xs], axis=1)
    X_quad = np.stack([np.ones_like(xs), xs, xs * xs], axis=1)
    lev_lin, m_lin, c_lin = evidence(
        X_lin, prior_var=np.array(prior_std[:2]) ** 2)
    lev_quad, m_quad, c_quad = evidence(
        X_quad, prior_var=np.array(prior_std) ** 2)
    lw_lin = np.log(p_linear) + lev_lin
    lw_quad = np.log(1.0 - p_linear) + lev_quad
    m = max(lw_lin, lw_quad)
    log_z = m + np.log(np.exp(lw_lin - m) + np.exp(lw_quad - m))
    return np.exp(lw_lin - log_z), m_lin, c_lin, m_quad, c_quad, log_z


def make_hierarchical_marginalized(n_points, p_linear=0.7):
    """The hierarchical model with the discrete gate summed out; args
    (xs, ys).

    log p(ys | a, b, c) = logaddexp(log p_lin + sum_i logN(y_i; a + b x, s),
                                    log (1 - p_lin)
                                    + sum_i logN(y_i; a + b x + c x^2, s))
    through the ``factor`` primitive: the fully continuous, non-quadratic
    form the gradient samplers run on. Returns the quadratic branch's
    log-likelihood less the linear one's (the gate's log-odds term).
    """

    @gen
    def hierarchical_marginalized(h, xs, ys):
        a = h.sample(normal, (0.0, 1.0), "coeffs/a")
        b = h.sample(normal, (0.0, 1.0), "coeffs/b")
        c = h.sample(normal, (0.0, 1.0), "coeffs/c")
        mean_lin = a + b * xs
        mean_quad = mean_lin + c * xs * xs
        ll_lin = torch.sum(normal.logpdf(ys, (mean_lin, NOISE)))
        ll_quad = torch.sum(normal.logpdf(ys, (mean_quad, NOISE)))
        h.factor(torch.logaddexp(math.log(p_linear) + ll_lin,
                                 math.log(1.0 - p_linear) + ll_quad),
                 "ys_marginal")
        return ll_quad - ll_lin

    return hierarchical_marginalized
