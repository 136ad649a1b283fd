"""Distributions beyond the reference's ten (counterpart of
modppl_tpu/dists/extra.py): ``exponential``, ``laplace``, ``student_t``,
``binomial``, ``dirichlet`` and ``negative_binomial``.

The log-densities are the reference's, with ``torch.lgamma`` and
``torch.special.xlogy`` for ``gammaln`` and ``xlogy``. Each carries the
reference's ``support``, so gradient inference picks the same bijector
(``exponential`` -> Exp). The samplers draw from the ``torch.Generator``
they are given; integer draws are int32, as the reference's.
"""

import math

import torch
from torch.special import xlogy

from modppl_tpu_torch.dists.base import Distribution, shape_of
from modppl_tpu_torch.dists.scalar import _standard_gamma, _tensors


def _exponentials(gen, shape, dtype, *params):
    shape = torch.broadcast_shapes(shape, *(shape_of(p) for p in params))
    return torch.empty(shape, dtype=dtype, device=gen.device).exponential_(
        generator=gen)


class Exponential(Distribution):
    """Exponential with rate lam: log lam - lam x on x >= 0."""

    support = "positive"

    def _logpdf(self, x, lam):
        x, lam = _tensors(x, lam)
        return torch.where(x >= 0.0, torch.log(lam) - lam * x, -math.inf)

    def _sample(self, gen, shape, dtype, lam):
        return _exponentials(gen, shape, dtype, lam) / lam


class Laplace(Distribution):
    """Laplace with (loc, scale): -|x - loc| / scale - log(2 scale); a draw
    is loc + scale (E1 - E2) of two unit exponentials."""

    def _logpdf(self, x, loc, scale):
        x, loc, scale = _tensors(x, loc, scale)
        return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)

    def _sample(self, gen, shape, dtype, loc, scale):
        e1 = _exponentials(gen, shape, dtype, loc, scale)
        e2 = _exponentials(gen, shape, dtype, loc, scale)
        return loc + scale * (e1 - e2)


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


exponential = Exponential()
laplace = Laplace()
student_t = StudentT()
binomial = Binomial()
dirichlet = Dirichlet()
negative_binomial = NegativeBinomial()
