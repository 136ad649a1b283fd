"""Simple DSL models: Bayesian linear regression and the 2-D pointed model
(counterpart of modppl_tpu/models/simple.py), with the user-defined
distribution ``uniform_2d``.

The bodies index trailing axes and stack along the last one, so they run
per trace and, over a leading lane axis, under the batched tier
(``importance_sampling(..., vectorized=True)``).
"""

import math
from dataclasses import dataclass

import torch

from modppl_tpu_torch.dists import Distribution, mvnormal, normal
from modppl_tpu_torch.modeling import gen


@dataclass(frozen=True)
class Bounds:
    """Rectangle bounds for ``Uniform2D``."""

    xmin: float
    xmax: float
    ymin: float
    ymax: float


class Uniform2D(Distribution):
    """Uniform over a rectangle; a point is the last axis (2,)."""

    event_rank = 1
    support = "other"

    def batched(self, params):
        return False  # the bounds are host numbers

    def _logpdf(self, p, b):
        x, y = p[..., 0], p[..., 1]
        inside = (b.xmin <= x) & (x <= b.xmax) & (b.ymin <= y) & (y <= b.ymax)
        area = (b.xmax - b.xmin) * (b.ymax - b.ymin)
        return torch.where(inside, torch.zeros_like(x) - math.log(area),
                           -math.inf)

    def _sample(self, gen, shape, dtype, b):
        u = torch.rand(tuple(shape) + (2,), generator=gen, device=gen.device,
                       dtype=dtype)
        return torch.stack([u[..., 0] * (b.xmax - b.xmin) + b.xmin,
                            u[..., 1] * (b.ymax - b.ymin) + b.ymin], dim=-1)


uniform_2d = Uniform2D()


@gen
def obs_model(h, slope, intercept, xs):
    """Observation model of Bayesian linear regression: one address a
    point, ``"0"``, ``"1"``, ..."""
    return torch.stack([h.sample(normal, (slope * x + intercept, 0.1), f"{i}")
                        for i, x in enumerate(xs)], dim=-1)


@gen
def line_model(h, xs):
    """Bayesian linear regression: prior over (slope, intercept), the
    points through ``obs_model`` at ``"ys"``."""
    slope = h.sample(normal, (0.0, 1.0), "slope")
    intercept = h.sample(normal, (0.0, 2.0), "intercept")
    return h.trace(obs_model, (slope, intercept, xs), "ys")


@gen
def pointed_2d_model(h, bounds, cov):
    """A uniform latent point and an mvnormal observation of it."""
    latent = h.sample(uniform_2d, bounds, "latent")
    return h.sample(mvnormal, (latent, cov), "obs")


@gen
def pointed_2d_drift_proposal(h, trace, noise):
    """Gaussian drift of the latent; the previous trace is the first
    argument."""
    prev_latent = trace.data.read("latent")
    h.sample(mvnormal, (prev_latent, noise), "latent")
