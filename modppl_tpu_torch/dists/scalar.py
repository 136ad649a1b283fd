"""Scalar distributions (counterpart of modppl_tpu/dists/scalar.py):
``bernoulli``, ``uniform``, ``uniform_discrete``, ``categorical``,
``normal``, ``geometric``, ``poisson``, ``gamma`` and ``beta``.

Every sampler draws from the ``torch.Generator`` it is given. Integer draws
(``uniform_discrete``, ``geometric``, ``poisson``) are int64. The log-gamma
terms are ``torch.lgamma``; ``beta``'s log normaliser adds in the
reference's order, lgamma(min) + (lgamma(max) - lgamma(a + b)).

Over lane keys (``sample_lanes``) each lane draws from its own words:
``geometric`` by inverting one uniform; ``uniform_discrete`` by rejection
on a 63-bit word (exact for any range); ``gamma`` by Marsaglia-Tsang
(with the boost u^(1/a) below a = 1), ``beta`` as two gammas from split
keys; ``poisson`` by a search of its CDF below rate POISSON_SWITCH and by
Hormann's PTRS at and above it, as ``jax.random.poisson`` switches.
"""

import math

import torch

from modppl_tpu_torch.core.keys import _bits_to_uniform, _srl, split_lanes
from modppl_tpu_torch.dists.base import (
    Distribution,
    cdf_search,
    rejection_draw,
    shape_of,
    standard_lanes,
)
from modppl_tpu_torch.utils.numerics import ordered_cumsum

#: a Poisson lane draw searches its CDF below this rate, else runs PTRS
POISSON_SWITCH = 10.0


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

    def _draw_lanes(self, key_lanes, shape, dtype, block, a, b):
        # a word's low 63 bits v, accepted below the largest multiple of the
        # width m (at least half of them): a + v mod m is then exactly
        # uniform on [a, b], for any width up to 2^62
        dev = key_lanes.device
        a = torch.as_tensor(a, device=dev).to(torch.int64)
        m = torch.as_tensor(b, device=dev).to(torch.int64) - a + 1
        top = torch.div((1 << 63) - 1, m, rounding_mode="floor") * m

        def propose(bits, a, m, top):
            v = _srl(bits[..., 0], 1)
            return a + torch.remainder(v, m), v < top

        return rejection_draw(key_lanes, shape, block, 1, propose, a, m, top,
                              unrolled=1)


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
    standard = "uniform"

    def _logpdf(self, k, p):
        k, p = _tensors(k, p)
        kf = k.to(p.dtype)
        return torch.where(k >= 0, torch.special.xlog1py(kf, -p)
                           + torch.log(p), -math.inf)

    def _sample(self, gen, shape, dtype, p):
        return self._from_standard(_uniform01(gen, shape, dtype, p), p)

    def _from_standard(self, u, p):
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

    def _draw_lanes(self, key_lanes, shape, dtype, block, rate):
        return poisson_lanes(key_lanes, shape, block, rate).to(torch.int64)


def _ptrs(bits, lam, done):
    """One round of Hormann's PTRS (transformed rejection with squeeze) for
    Poisson(lam), lam >= 10, from two words: (candidate, accepted);
    ``done`` elements accept at once."""
    u = _bits_to_uniform(bits[..., 0], torch.float64) - 0.5
    v = _bits_to_uniform(bits[..., 1], torch.float64)
    us = 0.5 - torch.abs(u)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2.0)
    k = torch.floor((2.0 * a / us + b) * u + lam + 0.43)
    s = torch.log(v * inv_alpha / (a / (us * us) + b))
    t = -lam + k * torch.log(lam) - torch.lgamma(k + 1.0)
    quick = (us >= 0.07) & (v <= v_r)
    reject = (k < 0) | ((us < 0.013) & (v > us))
    return k, done | quick | (~reject & (s <= t))


def poisson_lanes(key_lanes, shape, block, rate):
    """Poisson lane draws of ``shape`` (see ``rejection_draw``) as float64
    counts: a CDF search of one uniform (split key 0) where the rate is
    below POISSON_SWITCH, PTRS (split key 1) elsewhere. A host-number
    rate picks its arm on the host; a tensor one reads once which arms
    its elements need."""
    k_search, k_ptrs = split_lanes(key_lanes, 2).unbind(-1)
    if torch.is_tensor(rate):
        n_small = None
    else:
        n_small = math.prod(shape) if rate < POISSON_SWITCH else 0
    rate = torch.broadcast_to(torch.as_tensor(
        rate, dtype=torch.float64, device=key_lanes.device), shape)
    small = rate < POISSON_SWITCH
    if n_small is None:
        n_small = int(small.sum())  # the host read
    arms = (n_small > 0, n_small < small.numel() or n_small == 0)
    k = big = None
    if arms[0]:
        lam = torch.where(small, rate, 0.0)
        u = standard_lanes("uniform", k_search, shape[1:], torch.float64,
                           block)
        k = cdf_search(u, torch.exp(-lam), lambda j: lam / j)
    if arms[1]:
        big = rejection_draw(k_ptrs, shape, block, 2, _ptrs,
                             torch.where(small, POISSON_SWITCH, rate), small)
    if k is None or big is None:
        return big if k is None else k
    return torch.where(small, k, big)


def _marsaglia_tsang(bits, d, c):
    """One round of Marsaglia and Tsang's gamma sampler at d = a - 1/3,
    c = 1 / sqrt(9 d) from two words (a normal and a uniform):
    (log of the candidate d v, accepted)."""
    dtype = d.dtype
    z = torch.special.ndtri(_bits_to_uniform(bits[..., 0], dtype))
    u = _bits_to_uniform(bits[..., 1], dtype)
    v = 1.0 + c * z
    ok = v > 0
    v3 = torch.where(ok, v * v * v, 1.0)
    log_v3 = torch.log(v3)
    accept = ok & (torch.log(u) < 0.5 * z * z + d - d * v3 + d * log_v3)
    return torch.log(d) + log_v3, accept


def log_gamma_lanes(key_lanes, shape, dtype, block, a):
    """Logs of standard gamma lane draws of shape ``a`` and ``shape`` (see
    ``rejection_draw``): Marsaglia-Tsang from split key 0, at a + 1 with
    the boost log(u) / a from split key 1 where a < 1."""
    k_mt, k_boost = split_lanes(key_lanes, 2).unbind(-1)
    a = torch.broadcast_to(torch.as_tensor(a, dtype=dtype,
                                           device=key_lanes.device), shape)
    boost = a < 1.0
    d = torch.where(boost, a + 1.0, a) - 1.0 / 3.0
    log_g = rejection_draw(k_mt, shape, block, 2, _marsaglia_tsang, d,
                           1.0 / torch.sqrt(9.0 * d))
    u = standard_lanes("uniform", k_boost, shape[1:], dtype, block)
    return log_g + torch.where(boost, torch.log(u) / a, 0.0)


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

    def _draw_lanes(self, key_lanes, shape, dtype, block, a, b):
        return torch.exp(log_gamma_lanes(key_lanes, shape, dtype, block,
                                         a)) * b


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

    def _draw_lanes(self, key_lanes, shape, dtype, block, a, b):
        # X / (X + Y) as sigmoid(log X - log Y): no 0 / 0 where both
        # gammas underflow at small a and b
        ka, kb = split_lanes(key_lanes, 2).unbind(-1)
        return torch.sigmoid(log_gamma_lanes(ka, shape, dtype, block, a)
                             - log_gamma_lanes(kb, shape, dtype, block, b))


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
