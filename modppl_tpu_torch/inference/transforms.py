"""Unconstraining bijectors for gradient-based inference (counterpart of
modppl_tpu/inference/transforms.py).

The bijector for an address is derived from the ``Distribution.support``
metadata recorded on its trie leaf at trace time; it maps the support to
R^n so HMC runs in unconstrained space with the log-Jacobian correction.
"""

import math

import torch
import torch.nn.functional as F


def _zero_like(u):
    return u.new_zeros(()) if torch.is_tensor(u) else 0.0


class Bijector:
    """x = forward(u) with u unconstrained; ldj = log|d forward / du|."""

    def forward(self, u):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError

    def log_det_jacobian(self, u):
        raise NotImplementedError


class Identity(Bijector):
    def forward(self, u):
        return u

    def inverse(self, x):
        return x

    def log_det_jacobian(self, u):
        return _zero_like(u)


class Exp(Bijector):
    """R -> (0, inf)."""

    def forward(self, u):
        return torch.exp(u)

    def inverse(self, x):
        return torch.log(x)

    def log_det_jacobian(self, u):
        return torch.sum(u)


class Sigmoid(Bijector):
    """R -> (0, 1)."""

    def forward(self, u):
        return torch.sigmoid(u)

    def inverse(self, x):
        return torch.log(x) - torch.log1p(-x)

    def log_det_jacobian(self, u):
        return torch.sum(F.logsigmoid(u) + F.logsigmoid(-u))


class Interval(Bijector):
    """R -> (a, b) via a scaled sigmoid (static bounds)."""

    def __init__(self, a, b):
        self.a = a
        self.b = b

    def forward(self, u):
        return self.a + (self.b - self.a) * torch.sigmoid(u)

    def inverse(self, x):
        z = (x - self.a) / (self.b - self.a)
        return torch.log(z) - torch.log1p(-z)

    def log_det_jacobian(self, u):
        return torch.sum(F.logsigmoid(u) + F.logsigmoid(-u)
                         + math.log(self.b - self.a))


IDENTITY = Identity()
EXP = Exp()
SIGMOID = Sigmoid()

_BY_SUPPORT = {
    "real": IDENTITY,
    "positive": EXP,
    "unit_interval": SIGMOID,
}


def transform_for(dist):
    """Default bijector for a distribution, or None if unsupported."""
    if dist is None:
        return None
    return _BY_SUPPORT.get(dist.support)
