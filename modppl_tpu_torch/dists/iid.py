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

Over a scalar base, a per-lane parameter takes a plate axis at its end,
so that lane i's parameter meets lane i's n draws. A parameter is per lane
if its shape is the lane shape, where that is known: the axes of ``x``
before the plate's in ``logpdf`` (a 1-D ``x`` has none), ``(lanes,)`` in
``sample_lanes``. So when the lane count equals n, a 1-D parameter of
length n is per lane beside lanes and per element beside one trace's
``x``. A parameter whose last axis is neither n nor 1 is per lane in any
case. The lane form (``sample_lanes``) draws each lane's n standard
variates from its own stream.
"""

import torch

from modppl_tpu_torch.dists.base import (
    LANE_TODO,
    Distribution,
    _sample_dtype,
    as_param_tuple,
    shape_of,
    standard_lanes,
)


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
        self.standard = base.standard if base.event_rank == 0 else None

    def _plated(self, params, lanes=None):
        """Over a scalar base: each per-lane parameter (of the lane shape
        ``lanes``, or whose last axis is neither the plate's nor 1) with a
        plate axis at its end."""
        params = as_param_tuple(params)
        if self.base.event_rank:
            return params

        def per_lane(p):
            return torch.is_tensor(p) and p.ndim >= 1 and (
                tuple(p.shape) == lanes or p.shape[-1] not in (self.n, 1))

        return tuple(p[..., None] if per_lane(p) else p for p in params)

    def logpdf(self, x, params):
        lanes = (tuple(x.shape[:-1]) if not self.base.event_rank
                 and torch.is_tensor(x) and x.ndim >= 2 else None)
        return torch.sum(self.base.logpdf(x, self._plated(params, lanes)),
                         dim=-1)

    def sample_lanes(self, key_lanes, params, dtype=None, block=1):
        """Each lane's n draws from its lane's stream, (C,) + (n,)."""
        if self.standard is None:
            raise NotImplementedError(f"{self!r}: {LANE_TODO}")
        c = key_lanes.shape[0] * block
        params = self._plated(params, (c,))
        dtype = _sample_dtype(params, dtype)
        shape = torch.broadcast_shapes((c, self.n),
                                       *(shape_of(p) for p in params))
        if shape[0] != c:
            raise ValueError(f"{self!r}: parameters broadcast to {shape}, "
                             f"not to the {c} lanes")
        z = standard_lanes(self.standard, key_lanes, shape[1:], dtype, block)
        return self.base._from_standard(z, *params)

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
