"""Plate with elementwise log-densities (counterpart of
modppl_tpu/dists/plate.py).

``plate(dist, n)`` draws ``n`` iid values from one generator's stream and
scores them elementwise, unlike ``iid``, whose one vector-valued choice has
a summed log-density. The batched tier needs the elementwise form for
batch-aware kernels (``auto_batch=False``): the leading axis is the particle
axis, and each particle keeps its own log-probability, so weights come out
per particle. Parameters are scalars or tensors that broadcast against
``(n,)``.
"""

from modppl_tpu_torch.dists.base import Distribution, as_param_tuple


class Plate(Distribution):
    """n iid draws along a leading axis, scored elementwise."""

    def __init__(self, base, n):
        self.base = base
        self.n = n
        self.is_discrete = base.is_discrete
        self.support = base.support

    def logpdf(self, x, params):
        return self.base._logpdf(x, *as_param_tuple(params))

    def sample(self, gen, params, dtype=None):
        return self.base.sample_batch(gen, (self.n,), params, dtype=dtype)

    def from_standard(self, z, params):
        return self.base.from_standard(z, params)

    def __repr__(self):
        return f"Plate({self.base!r}, n={self.n})"


def plate(base, n):
    """``plate(normal, n)``: n iid normals, one stream, elementwise logp."""
    return Plate(base, n)
