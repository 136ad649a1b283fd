"""IID ("plate") distribution: one address holds a vector of n independent
draws (counterpart of modppl_tpu/dists/iid.py).

``h.sample(iid(normal, n), params, "ys")`` draws shape (n,) values with
``logpdf = sum_i base.logpdf(x_i, params_i)``; a parameter either has a
leading axis of length n or is shared by every draw. The base must be a
scalar distribution: its parameters then broadcast against ``x``.
"""

import torch

from modppl_tpu_torch.dists.base import Distribution, as_param_tuple


class IID(Distribution):
    """n independent draws from ``base`` as one vector-valued choice."""

    event_rank = 1

    def __init__(self, base, n):
        self.base = base
        self.n = n
        self.is_discrete = base.is_discrete
        self.support = base.support

    def logpdf(self, x, params):
        return torch.sum(self.base.logpdf(x, params))

    def sample(self, gen, params, dtype=None):
        return self.base.sample_batch(gen, (self.n,), as_param_tuple(params),
                                      dtype=dtype)

    def __repr__(self):
        return f"IID({self.base!r}, n={self.n})"


def iid(base, n):
    """Plate constructor: ``iid(normal, 11)`` ~ 11 independent normals."""
    return IID(base, n)
