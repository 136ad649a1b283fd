"""Scalar distributions (counterpart of modppl_tpu/dists/scalar.py):
``bernoulli``, ``uniform``, ``uniform_discrete``, ``categorical``,
``normal``, ``geometric``, ``poisson``, ``gamma`` and ``beta``.

Every sampler draws from the ``torch.Generator`` it is given. Integer draws
(``uniform_discrete``, ``geometric``, ``poisson``) are int64. The log-gamma
terms are ``torch.lgamma``; ``beta``'s log normaliser adds in the
reference's order, lgamma(min) + (lgamma(max) - lgamma(a + b)).
"""

import math

import torch

from modppl_tpu_torch.dists.base import Distribution, shape_of
from modppl_tpu_torch.utils.numerics import ordered_cumsum


def _log(v):
    return torch.log(v) if torch.is_tensor(v) else math.log(v)


def _tensors(*xs):
    """``xs`` as tensors on the device of the first tensor among them, in
    the dtype of the first floating one (else torch's default float)."""
    like = next((x for x in xs if torch.is_tensor(x)), None)
    dtype = next((x.dtype for x in xs
                  if torch.is_tensor(x) and x.is_floating_point()),
                 torch.get_default_dtype())
    dev = like.device if like is not None else None
    return tuple(x.to(dev) if torch.is_tensor(x)
                 else torch.as_tensor(x, dtype=dtype, device=dev) for x in xs)


def _uniform01(gen, shape, dtype, *params):
    shape = torch.broadcast_shapes(shape, *(shape_of(p) for p in params))
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


class Bernoulli(Distribution):
    """Bernoulli over {True, False} with success probability p."""

    is_discrete = True
    support = "discrete"
    standard = "uniform"

    def _logpdf(self, x, p):
        if not torch.is_tensor(x) and not torch.is_tensor(p):
            return math.log(p if x else 1.0 - p)
        dev = x.device if torch.is_tensor(x) else p.device
        x = torch.as_tensor(x, dtype=torch.bool, device=dev)
        return torch.log(torch.where(x, p, 1.0 - p))

    def _sample(self, gen, shape, dtype, p):
        shape = torch.broadcast_shapes(shape, shape_of(p))
        return torch.rand(shape, generator=gen, device=gen.device,
                          dtype=dtype) < p

    def _from_standard(self, u, p):
        return u < p


class UniformContinuous(Distribution):
    """Uniform on [a, b], inclusive bounds, -inf outside."""

    support = "other"  # an interval whose bounds are parameters
    standard = "uniform"

    @staticmethod
    def _check(a, b):
        # only host numbers are checked: a tensor check would sync the device
        if not torch.is_tensor(a) and not torch.is_tensor(b) and a >= b:
            raise ValueError(
                f"a >= b in [a, b] = [{a}, {b}]; b > a is required.")

    def _logpdf(self, x, a, b):
        self._check(a, b)
        inside = (a <= x) & (x <= b)
        return torch.where(inside, -_log(b - a) + torch.zeros_like(x),
                           -math.inf)

    def _sample(self, gen, shape, dtype, a, b):
        self._check(a, b)
        return self._from_standard(_uniform01(gen, shape, dtype, a, b), a, b)

    def _from_standard(self, u, a, b):
        return u * (b - a) + a


class UniformDiscrete(Distribution):
    """Uniform integers on [a, b], inclusive bounds, -inf outside."""

    is_discrete = True
    support = "discrete"

    def _logpdf(self, x, a, b):
        x, a, b = _tensors(x, a, b)
        inside = (a <= x) & (x <= b)
        width = b - a + 1
        if not width.is_floating_point():
            width = width.to(torch.get_default_dtype())
        return torch.where(inside, -torch.log(width), -math.inf)

    def _sample(self, gen, shape, dtype, a, b):
        if not torch.is_tensor(a) and not torch.is_tensor(b):
            return torch.randint(int(a), int(b) + 1, shape, generator=gen,
                                 device=gen.device, dtype=torch.int64)
        u = _uniform01(gen, shape, torch.float64, a, b)
        return (torch.floor(u * (b - a + 1)) + a).to(torch.int64)


# up to this many categories a draw runs the K-1 comparisons as elementwise
# ops (the HMM's K = 3); above it, one binary search a draw
SMALL_K = 8


def _row_cdf(rows):
    """Cumulative sums along the last axis of the (R, K) ``rows``, in a
    fixed add order. A single row takes ``ordered_cumsum``: on the card a
    ``torch.cumsum`` over one row is CUB's look-back scan, not
    deterministic in the last bit, and PyTorch's per-row scan of one long
    row (K = N = 2^24) is slow. Several rows take ``torch.cumsum`` along
    the last axis, PyTorch's per-row scan, whose add order is fixed
    (utils/numerics.py), so the same key gives the same indices either
    way."""
    if rows.shape[0] == 1:
        return ordered_cumsum(rows[0])[None]
    return torch.cumsum(rows, -1)


class Categorical(Distribution):
    """An integer index distributed by a probability vector (the last axis
    of ``probs``; leading axes are a batch, e.g. one row per particle). An
    index outside [0, K) scores -inf. Draws are int32, by inverse CDF: one
    uniform per draw against the row's cumulative probabilities, so a
    zero-probability index is never drawn. Up to ``SMALL_K`` categories
    the running sums and the comparisons are elementwise ops; above it the
    draws, in draw order, are binary searches (``torch.searchsorted``) of a
    cumulative sum taken in a fixed order (``_row_cdf``), so the same key
    gives the same indices (importance resampling draws from K = N
    weights)."""

    is_discrete = True
    support = "discrete"
    standard = "uniform"

    def batched(self, params):
        # the probability axis is the event; a batch is any axis before it
        (probs,) = params
        return torch.is_tensor(probs) and probs.ndim > 1

    def _lane_shape(self, params):
        (probs,) = params
        return tuple(probs.shape[:-1])

    def _logpdf(self, x, probs):
        k = probs.shape[-1]
        x = torch.as_tensor(x, device=probs.device)
        inside = (x >= 0) & (x < k)
        safe = torch.clamp(x, 0, k - 1).long()
        batch = torch.broadcast_shapes(safe.shape, probs.shape[:-1])
        p = torch.gather(probs.expand(*batch, k), -1,
                         safe.expand(batch)[..., None])[..., 0]
        return torch.where(inside, torch.log(p), -math.inf)

    def _sample(self, gen, shape, dtype, probs):
        batch = torch.broadcast_shapes(shape, probs.shape[:-1])
        u = torch.rand(batch, generator=gen, device=gen.device,
                       dtype=probs.dtype)
        return self._from_standard(u, probs)

    def _from_standard(self, u, probs):
        """The index one uniform ``u`` a draw gives (``u`` the draws' batch
        shape)."""
        k = probs.shape[-1]
        if k > SMALL_K:
            return self._search(u, probs)
        # the running sums over the K columns, one elementwise add each (a
        # torch.cumsum over K = 3 columns of 2^20 rows is a slow scan on the
        # card)
        cdf = [probs[..., 0]]
        for j in range(1, k):
            cdf.append(cdf[-1] + probs[..., j])
        u = u * cdf[-1]
        # index = #{k < K - 1 : cdf_k <= u}: a zero-probability index is
        # never drawn
        idx = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
        for c in cdf[:-1]:
            idx += c <= u
        return idx

    @staticmethod
    def _search(u, probs):
        """The large-K arm: the same rule, #{k : cdf_k <= u} clamped to
        K - 1, by ``searchsorted(cdf, u, right=True)``: one row searched
        by every draw, or one row a draw."""
        k = probs.shape[-1]
        batch = u.shape
        cdf = _row_cdf(probs.reshape(-1, k))
        if cdf.shape[0] == 1:
            u = u.reshape(1, -1)
        else:
            cdf = cdf.reshape(probs.shape).expand(*batch, k).reshape(-1, k)
            u = u.reshape(-1, 1)
        idx = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
        return torch.clamp(idx, max=k - 1).to(torch.int32).reshape(batch)


class Normal(Distribution):
    """Gaussian with (mu, std-dev) parameters: -(z^2 + ln 2pi)/2 - ln sigma."""

    standard = "normal"

    def _logpdf(self, x, mu, std):
        z = (x - mu) / std
        return -(z * z + math.log(2.0 * math.pi)) / 2.0 - _log(std)

    def _sample(self, gen, shape, dtype, mu, std):
        shape = torch.broadcast_shapes(shape, shape_of(mu), shape_of(std))
        z = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
        return self._from_standard(z, mu, std)

    def _from_standard(self, z, mu, std):
        return z * std + mu


class Geometric(Distribution):
    """The number of failures before the first success, success
    probability p; draws by inverse CDF, floor(log(1 - u) / log(1 - p))."""

    is_discrete = True
    support = "discrete"

    def _logpdf(self, k, p):
        k, p = _tensors(k, p)
        kf = k.to(p.dtype)
        return torch.where(k >= 0, torch.special.xlog1py(kf, -p)
                           + torch.log(p), -math.inf)

    def _sample(self, gen, shape, dtype, p):
        u = _uniform01(gen, shape, dtype, p)
        return torch.floor(torch.log1p(-u) / _log1p_neg(p)).to(torch.int64)


def _log1p_neg(p):
    return torch.log1p(-p) if torch.is_tensor(p) else math.log1p(-p)


class Poisson(Distribution):
    """Poisson with rate lambda: k ln(lambda) - lambda - ln k!."""

    is_discrete = True
    support = "discrete"

    def _logpdf(self, k, rate):
        k, rate = _tensors(k, rate)
        kf = k.to(rate.dtype)
        return torch.where(k >= 0, torch.special.xlogy(kf, rate) - rate
                           - torch.lgamma(kf + 1.0), -math.inf)

    def _sample(self, gen, shape, dtype, rate):
        shape = torch.broadcast_shapes(shape, shape_of(rate))
        rates = torch.as_tensor(rate, dtype=dtype, device=gen.device)
        return torch.poisson(rates.expand(shape).contiguous(),
                             generator=gen).to(torch.int64)


def _standard_gamma(gen, shape, dtype, a):
    shape = torch.broadcast_shapes(shape, shape_of(a))
    alpha = torch.as_tensor(a, dtype=dtype, device=gen.device)
    return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                 generator=gen)


class Gamma(Distribution):
    """Gamma with shape a and scale b:
    (a - 1) ln x - x / b - lnGamma(a) - a ln b."""

    support = "positive"

    def _logpdf(self, x, a, b):
        x, a, b = _tensors(x, a, b)
        return ((a - 1.0) * torch.log(x) - x / b - torch.lgamma(a)
                - a * torch.log(b))

    def _sample(self, gen, shape, dtype, a, b):
        shape = torch.broadcast_shapes(shape, shape_of(b))
        return _standard_gamma(gen, shape, dtype, a) * b


class Beta(Distribution):
    """Beta(a, b): (a - 1) ln x + (b - 1) ln(1 - x) - ln B(a, b); draws as
    X / (X + Y) of two standard gammas."""

    support = "unit_interval"

    def _logpdf(self, x, a, b):
        x, a, b = _tensors(x, a, b)
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        betaln = torch.lgamma(lo) + (torch.lgamma(hi) - torch.lgamma(a + b))
        return (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - betaln

    def _sample(self, gen, shape, dtype, a, b):
        shape = torch.broadcast_shapes(shape, shape_of(a), shape_of(b))
        x = _standard_gamma(gen, shape, dtype, a)
        y = _standard_gamma(gen, shape, dtype, b)
        return x / (x + y)


bernoulli = Bernoulli()
uniform_continuous = UniformContinuous()
uniform = uniform_continuous
uniform_discrete = UniformDiscrete()
categorical = Categorical()
normal = Normal()
geometric = Geometric()
poisson = Poisson()
gamma = Gamma()
beta = Beta()
