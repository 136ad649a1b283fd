"""Spiral tracking (counterpart of modppl_tpu/models/spiral.py).

A polar-coordinate random walk observed through an mvnormal. The kernels
are written for the batched tier: the state ``pol`` has a leading particle
axis, so the body indexes trailing axes (``pol[..., 0]``), and so runs
unbatched too. ``spiral_model`` is the eager ``Unfold`` of
``spiral_kernel``, which branches on the Python int t.
"""

import math

import torch

from modppl_tpu_torch.dists import mvnormal, normal, uniform
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.unfold import Unfold

# constant observation covariance: factored once, broadcast over particles
OBS_COV = ((0.001, 0.0), (0.0, 0.001))


def polar_to_cartesian(pol):
    r, theta = pol[..., 0], pol[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


@gen
def spiral_init(h, _state0):
    """t == 0 arm of the spiral kernel."""
    r = h.sample(uniform, (0.0, 1.0), "r")
    theta = h.sample(uniform, (0.0, 2.0 * math.pi), "theta")
    pol = torch.stack([r, theta], dim=-1)
    h.sample(mvnormal, (polar_to_cartesian(pol), OBS_COV), "obs")
    return pol


@gen
def spiral_step(h, t, prev_pol):
    """t >= 1 arm of the spiral kernel."""
    dr = h.sample(normal, (0.0, 0.1), "dr")
    dtheta = h.sample(normal, (0.4, 0.2), "dtheta")
    pol = torch.stack([prev_pol[..., 0] + dr, prev_pol[..., 1] + dtheta],
                      dim=-1)
    h.sample(mvnormal, (polar_to_cartesian(pol), OBS_COV), "obs")
    return pol


def spiral_scan_kernel():
    from modppl_tpu_torch.inference.vsmc import ScanKernel
    return ScanKernel(spiral_init, spiral_step)


def circle_observations(num_steps):
    """The headline run's observations: points on a circle of radius 0.4,
    one every 1/16 turn, as ``(num_steps, 2)`` float64 numbers."""
    return [[0.4 * math.cos(2 * math.pi * t / 16.0),
             0.4 * math.sin(2 * math.pi * t / 16.0)]
            for t in range(num_steps)]


@gen
def spiral_kernel(h, t, prev_pol):
    """The eager kernel: ``spiral_init``'s body at t == 0 (a Python int),
    ``spiral_step``'s after."""
    if t == 0:
        return spiral_init.fn(h, prev_pol)
    return spiral_step.fn(h, t, prev_pol)


spiral_model = Unfold(spiral_kernel)
