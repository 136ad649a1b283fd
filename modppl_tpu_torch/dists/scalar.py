"""Scalar distributions: ``bernoulli``, ``uniform``, ``categorical`` and
``normal`` (counterpart of modppl_tpu/dists/scalar.py:30-78, 99-148)."""

import math

import torch

from modppl_tpu_torch.dists.base import Distribution, shape_of


def _log(v):
    return torch.log(v) if torch.is_tensor(v) else math.log(v)


class Bernoulli(Distribution):
    """Bernoulli over {True, False} with success probability p."""

    is_discrete = True
    support = "discrete"

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


class UniformContinuous(Distribution):
    """Uniform on [a, b], inclusive bounds, -inf outside."""

    support = "other"  # an interval whose bounds are parameters

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
        shape = torch.broadcast_shapes(shape, shape_of(a), shape_of(b))
        u = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
        return u * (b - a) + a


class Categorical(Distribution):
    """An integer index distributed by a probability vector (the last axis
    of ``probs``; leading axes are a batch, e.g. one row per particle). An
    index outside [0, K) scores -inf. Draws are int32, by inverse CDF: one
    uniform per draw against the row's cumulative probabilities."""

    is_discrete = True
    support = "discrete"

    def batched(self, params):
        # the probability axis is the event; a batch is any axis before it
        (probs,) = params
        return torch.is_tensor(probs) and probs.ndim > 1

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
        # the running sums over the K columns, one elementwise add each (a
        # torch.cumsum over K = 3 columns of 2^20 rows is a slow scan on the
        # card)
        cdf = [probs[..., 0]]
        for k in range(1, probs.shape[-1]):
            cdf.append(cdf[-1] + probs[..., k])
        u = torch.rand(batch, generator=gen, device=gen.device,
                       dtype=probs.dtype) * cdf[-1]
        # index = #{k < K - 1 : cdf_k <= u}: a zero-probability index is
        # never drawn
        idx = torch.zeros(batch, dtype=torch.int32, device=gen.device)
        for c in cdf[:-1]:
            idx += c <= u
        return idx


class Normal(Distribution):
    """Gaussian with (mu, std-dev) parameters: -(z^2 + ln 2pi)/2 - ln sigma."""

    def _logpdf(self, x, mu, std):
        z = (x - mu) / std
        return -(z * z + math.log(2.0 * math.pi)) / 2.0 - _log(std)

    def _sample(self, gen, shape, dtype, mu, std):
        shape = torch.broadcast_shapes(shape, shape_of(mu), shape_of(std))
        z = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
        return z * std + mu


bernoulli = Bernoulli()
uniform_continuous = UniformContinuous()
uniform = uniform_continuous
categorical = Categorical()
normal = Normal()
