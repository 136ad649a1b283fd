"""Distributions beyond the reference's ten (counterpart of
modppl_tpu/dists/extra.py): ``exponential``, ``laplace``, ``student_t``,
``binomial``, ``dirichlet`` and ``negative_binomial``.

The log-densities are the reference's, with ``torch.lgamma`` and
``torch.special.xlogy`` for ``gammaln`` and ``xlogy``. Each carries the
reference's ``support``, so gradient inference picks the same bijector
(``exponential`` -> Exp). The samplers draw from the ``torch.Generator``
they are given; integer draws are int32, as the reference's.

Over lane keys: ``exponential`` and ``laplace`` invert one uniform;
``student_t`` is one normal over a gamma (split keys); ``binomial``
searches its CDF where n min(p, 1 - p) <= BINOMIAL_SWITCH and runs
Hormann's BTRS above, as ``jax.random.binomial`` switches; ``dirichlet``
normalises k gammas; ``negative_binomial`` is a gamma, then a Poisson of
it from a split key, as the reference splits ``k_g, k_p``.
"""

import math

import torch
from torch.special import xlogy

from modppl_tpu_torch.core.keys import _bits_to_uniform, split_lanes
from modppl_tpu_torch.dists.base import (
    Distribution,
    cdf_search,
    rejection_draw,
    shape_of,
    standard_lanes,
)
from modppl_tpu_torch.dists.scalar import (
    _standard_gamma,
    _tensors,
    log_gamma_lanes,
    poisson_lanes,
)

#: a binomial lane draw searches its CDF while n min(p, 1 - p) is at most
#: this, else runs BTRS
BINOMIAL_SWITCH = 10.0


def _exponentials(gen, shape, dtype, *params):
    shape = torch.broadcast_shapes(shape, *(shape_of(p) for p in params))
    return torch.empty(shape, dtype=dtype, device=gen.device).exponential_(
        generator=gen)


class Exponential(Distribution):
    """Exponential with rate lam: log lam - lam x on x >= 0."""

    support = "positive"
    standard = "uniform"

    def _logpdf(self, x, lam):
        x, lam = _tensors(x, lam)
        return torch.where(x >= 0.0, torch.log(lam) - lam * x, -math.inf)

    def _sample(self, gen, shape, dtype, lam):
        return _exponentials(gen, shape, dtype, lam) / lam

    def _from_standard(self, u, lam):
        return -torch.log(u) / lam


class Laplace(Distribution):
    """Laplace with (loc, scale): -|x - loc| / scale - log(2 scale); a draw
    is loc + scale (E1 - E2) of two unit exponentials; a lane draw inverts
    one uniform."""

    standard = "uniform"

    def _logpdf(self, x, loc, scale):
        x, loc, scale = _tensors(x, loc, scale)
        return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)

    def _sample(self, gen, shape, dtype, loc, scale):
        e1 = _exponentials(gen, shape, dtype, loc, scale)
        e2 = _exponentials(gen, shape, dtype, loc, scale)
        return loc + scale * (e1 - e2)

    def _from_standard(self, u, loc, scale):
        c = u - 0.5
        return loc - scale * torch.sign(c) * torch.log1p(-2.0 * torch.abs(c))


class StudentT(Distribution):
    """Student's t with (df, loc, scale); a draw is loc + scale z /
    sqrt(chi2 / df), chi2 = 2 Gamma(df / 2)."""

    def _logpdf(self, x, df, loc, scale):
        x, df, loc, scale = _tensors(x, df, loc, scale)
        z = (x - loc) / scale
        half = (df + 1.0) / 2.0
        return (torch.lgamma(half) - torch.lgamma(df / 2.0)
                - 0.5 * torch.log(df * math.pi) - torch.log(scale)
                - half * torch.log1p(z * z / df))

    def _sample(self, gen, shape, dtype, df, loc, scale):
        shape = torch.broadcast_shapes(shape, shape_of(df), shape_of(loc),
                                       shape_of(scale))
        z = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
        chi2 = 2.0 * _standard_gamma(gen, shape, dtype, torch.as_tensor(
            df, dtype=dtype, device=gen.device) / 2.0)
        return loc + scale * z / torch.sqrt(chi2 / df)

    def _draw_lanes(self, key_lanes, shape, dtype, block, df, loc, scale):
        kz, kg = split_lanes(key_lanes, 2).unbind(-1)
        z = standard_lanes("normal", kz, shape[1:], dtype, block)
        half = torch.as_tensor(df, dtype=dtype, device=key_lanes.device) / 2.0
        chi2 = 2.0 * torch.exp(log_gamma_lanes(kg, shape, dtype, block, half))
        return loc + scale * z / torch.sqrt(chi2 / df)


class Binomial(Distribution):
    """Successes k in {0..n} of n trials with probability p."""

    is_discrete = True
    support = "discrete"

    def _logpdf(self, k, n, p):
        k, n, p = _tensors(k, n, p)
        kf, nf = k.to(p.dtype), n.to(p.dtype)
        # xlogy guards: at p = 0 (k = 0) and p = 1 (k = n) the naive
        # k log(p) terms are 0 * (-inf) = NaN; xlogy gives the exact 0.0
        logp = (torch.lgamma(nf + 1.0) - torch.lgamma(kf + 1.0)
                - torch.lgamma(nf - kf + 1.0) + xlogy(kf, p)
                + xlogy(nf - kf, 1.0 - p))
        return torch.where((kf >= 0) & (kf <= nf), logp, -math.inf)

    def _sample(self, gen, shape, dtype, n, p):
        shape = torch.broadcast_shapes(shape, shape_of(n), shape_of(p))
        kw = dict(dtype=dtype, device=gen.device)
        count = torch.as_tensor(n, **kw).expand(shape).contiguous()
        prob = torch.as_tensor(p, **kw).expand(shape).contiguous()
        return torch.binomial(count, prob, generator=gen).to(torch.int32)

    def _draw_lanes(self, key_lanes, shape, dtype, block, n, p):
        k_search, k_btrs = split_lanes(key_lanes, 2).unbind(-1)
        kw = dict(dtype=torch.float64, device=key_lanes.device)
        n = torch.broadcast_to(torch.floor(torch.as_tensor(n, **kw)), shape)
        p = torch.broadcast_to(torch.as_tensor(p, **kw), shape)
        flip = p > 0.5
        q = torch.where(flip, 1.0 - p, p)
        small = n * q <= BINOMIAL_SWITCH
        # the search on one uniform where n q is small
        n_s = torch.where(small, n, 0.0)
        odds = q / (1.0 - q)
        u = standard_lanes("uniform", k_search, shape[1:], torch.float64,
                           block)
        k = cdf_search(u, torch.exp(n_s * torch.log1p(-q)),
                       lambda j: (n_s - j + 1.0) / j * odds, limit=n_s)
        if not bool(small.all()):  # the host read
            big = rejection_draw(k_btrs, shape, block, 2, _btrs,
                                 torch.where(small, 1e4, n),
                                 torch.where(small, 0.5, q), small)
            k = torch.where(small, k, big)
        return torch.where(flip, n - k, k).to(torch.int32)


def _btrs(bits, n, q, done):
    """One round of Hormann's BTRS (transformed rejection with squeeze) for
    Binomial(n, q), n q > 10, q <= 1/2, from two words: (candidate,
    accepted); ``done`` elements accept at once."""
    u = _bits_to_uniform(bits[..., 0], torch.float64) - 0.5
    v = _bits_to_uniform(bits[..., 1], torch.float64)
    us = 0.5 - torch.abs(u)
    spq = torch.sqrt(n * q * (1.0 - q))
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * q
    alpha = (2.83 + 5.1 / b) * spq
    v_r = 0.92 - 4.2 / b
    m = torch.floor((n + 1.0) * q)
    k = torch.floor((2.0 * a / us + b) * u + n * q + 0.5)
    quick = (us >= 0.07) & (v <= v_r)
    inside = (k >= 0) & (k <= n)
    kc = torch.clamp(k, min=0.0)
    kc = torch.minimum(kc, n)
    lhs = torch.log(v * alpha / (a / (us * us) + b))
    rhs = (torch.lgamma(m + 1.0) + torch.lgamma(n - m + 1.0)
           - torch.lgamma(kc + 1.0) - torch.lgamma(n - kc + 1.0)
           + (kc - m) * torch.log(q / (1.0 - q)))
    return k, done | quick | (inside & (lhs <= rhs))


class Dirichlet(Distribution):
    """Dirichlet over the simplex (the last axis); params: the
    concentration vector alpha. A draw normalises independent gammas."""

    event_rank = 1
    support = "other"  # a simplex: no default scalar bijector

    def batched(self, params):
        (alpha,) = params
        return torch.is_tensor(alpha) and alpha.ndim > 1

    def _logpdf(self, x, alpha):
        x, alpha = _tensors(x, alpha)
        norm = (torch.lgamma(torch.sum(alpha, -1))
                - torch.sum(torch.lgamma(alpha), -1))
        return norm + torch.sum((alpha - 1.0) * torch.log(x), -1)

    def _sample(self, gen, shape, dtype, alpha):
        alpha = torch.as_tensor(alpha, dtype=dtype, device=gen.device)
        g = _standard_gamma(gen, torch.broadcast_shapes(
            shape + alpha.shape[-1:], alpha.shape), dtype, alpha)
        return g / torch.sum(g, -1, keepdim=True)

    def _draw_lanes(self, key_lanes, shape, dtype, block, alpha):
        return torch.softmax(log_gamma_lanes(key_lanes, shape, dtype, block,
                                             alpha), -1)


class NegativeBinomial(Distribution):
    """k failures before the r-th success, success probability p (the
    reference's geometric is r = 1); a draw is a gamma-Poisson mixture."""

    is_discrete = True
    support = "discrete"

    def _logpdf(self, k, r, p):
        k, r, p = _tensors(k, r, p)
        kf, rf = k.to(p.dtype), r.to(p.dtype)
        # xlogy guard: at p = 1 (k = 0) the naive k log1p(-p) is NaN
        logp = (torch.lgamma(kf + rf) - torch.lgamma(rf)
                - torch.lgamma(kf + 1.0) + rf * torch.log(p)
                + xlogy(kf, 1.0 - p))
        return torch.where(kf >= 0, logp, -math.inf)

    def _sample(self, gen, shape, dtype, r, p):
        shape = torch.broadcast_shapes(shape, shape_of(r), shape_of(p))
        lam = _standard_gamma(gen, shape, dtype, r) * (1.0 - p) / p
        return torch.poisson(lam, generator=gen).to(torch.int32)

    def _draw_lanes(self, key_lanes, shape, dtype, block, r, p):
        k_g, k_p = split_lanes(key_lanes, 2).unbind(-1)
        lam = torch.exp(log_gamma_lanes(k_g, shape, dtype, block, r)) \
            * (1.0 - p) / p
        return poisson_lanes(k_p, shape, block, lam).to(torch.int32)


exponential = Exponential()
laplace = Laplace()
student_t = StudentT()
binomial = Binomial()
dirichlet = Dirichlet()
negative_binomial = NegativeBinomial()
