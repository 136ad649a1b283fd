"""IID ("plate") distribution: one address holds a vector of n independent
draws (counterpart of modppl_tpu/dists/iid.py).

``h.sample(iid(normal, n), params, "ys")`` draws shape (n, ...) values with
``logpdf = sum_i base.logpdf(x_i, params_i)``. A parameter whose leading
axis has length n is per element; any other is shared by every draw (the
reference's ``_has_batch_axis``). Both broadcast against ``x``: the base's
log-density is elementwise over leading axes, so only the plate's own axis
is summed and a leading lane axis survives. Under the batched tier
(modeling/autobatch.py) ``x`` is (lanes, n, ...) and the log-density
(lanes,); per lane under ``vmap`` it is a scalar.
"""

import torch

from modppl_tpu_torch.dists.base import Distribution, as_param_tuple


def _has_batch_axis(p, n):
    """A parameter takes part in the plate iff its leading axis is n."""
    return torch.is_tensor(p) and p.ndim >= 1 and p.shape[0] == n


class IID(Distribution):
    """n independent draws from ``base`` as one vector-valued choice."""

    event_rank = 1

    def __init__(self, base, n):
        self.base = base
        self.n = n
        self.is_discrete = base.is_discrete
        self.support = base.support

    def logpdf(self, x, params):
        return torch.sum(self.base.logpdf(x, params), dim=-1)

    def sample(self, gen, params, dtype=None):
        return self.base.sample_batch(gen, (self.n,), as_param_tuple(params),
                                      dtype=dtype)

    def sample_batch(self, gen, shape, params, dtype=None):
        return self.base.sample_batch(gen, tuple(shape) + (self.n,),
                                      as_param_tuple(params), dtype=dtype)

    def batched(self, params):
        # a lane axis is one beyond the base's own, less the plate's axis of
        # a per-element parameter
        return self.base.batched(tuple(
            p[0] if _has_batch_axis(p, self.n) else p
            for p in as_param_tuple(params)))

    def __repr__(self):
        return f"IID({self.base!r}, n={self.n})"


def iid(base, n):
    """Plate constructor: ``iid(normal, 11)`` ~ 11 independent normals."""
    return IID(base, n)
