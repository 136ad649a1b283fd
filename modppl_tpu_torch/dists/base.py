"""Distribution protocol (counterpart of modppl_tpu/dists/base.py).

``logpdf(x, params)`` is plain tensor arithmetic that broadcasts over any
leading particle axis. ``sample(gen, params)`` and
``sample_batch(gen, shape, params)`` draw from a ``torch.Generator`` on the
generator's own device. Parameters may be tensors or Python numbers; Python
numbers stay host scalars in the arithmetic, so a constant parameter never
costs a host-to-device copy.

Parameter conventions follow the reference: std-dev normal, inclusive
uniform bounds, shape/scale gamma, k-failures geometric.

``Standard(z)`` carries a sampler's standard draws (the normal or uniform
variates before its parameters shape them) into a draw site:
``from_standard(z, params)`` finishes the draw with the sampler's own
arithmetic. A test that feeds a site whose parameters differ per particle
the reference's draws passes them so.
"""

import torch

from modppl_tpu_torch.core.keys import generator, normal_lanes, uniform_lanes

LANE_TODO = ("no lane form (sample_lanes): only normal, uniform, bernoulli, "
             "categorical, mvnormal and iid over a scalar one of these draw "
             "from per-lane key streams so far (ROADMAP Queue 1 item 13)")


def u01(key, shape=(), device=None):
    """Uniform [0, 1) draws of ``shape`` from the stream of the host key
    ``key``, the primitive the samplers build on, on the card unless
    ``device`` names another (``device="cpu"``)."""
    from modppl_tpu_torch.modeling.handlers import entry_device

    device = entry_device(device, "u01")
    return torch.rand(shape, generator=generator(key, device), device=device)


def as_param_tuple(params):
    """Normalize params: a bare scalar becomes a 1-tuple."""
    if isinstance(params, tuple):
        return params
    return (params,)


def shape_of(p):
    return tuple(p.shape) if torch.is_tensor(p) else ()


def _sample_dtype(params, dtype):
    """The dtype of the first floating tensor parameter, else ``dtype``,
    else torch's default."""
    for p in params:
        if torch.is_tensor(p) and p.is_floating_point():
            return p.dtype
    return dtype if dtype is not None else torch.get_default_dtype()


def standard_lanes(kind, key_lanes, shape, dtype, block=1):
    """(C * block,) + ``shape`` standard variates (``kind`` "normal" or
    "uniform"), key i's stream giving lanes [i * block, (i + 1) * block)
    as one plate; with ``block`` 1 a lane's variates are its key's
    ``shape`` draw."""
    draw = normal_lanes if kind == "normal" else uniform_lanes
    if block == 1:
        return draw(key_lanes, shape, dtype)
    z = draw(key_lanes, (block,) + tuple(shape), dtype)
    return z.reshape((key_lanes.shape[0] * block,) + tuple(shape))


class Standard:
    """A sampler's standard draws, pre-drawn (see ``from_standard``)."""

    __slots__ = ("z",)

    def __init__(self, z):
        self.z = z


class Distribution:
    """A sampling distribution with an analytic log-density.

    Subclasses implement ``_logpdf(x, *params)``,
    ``_sample(gen, shape, dtype, *params)`` (``shape`` is the batch shape,
    broadcast with the parameters' own) and may set ``event_rank``.
    """

    #: rank of one draw (0 for scalar distributions, 1 for vectors)
    event_rank = 0

    #: True if draws live in a discrete space (no gradient flows through them)
    is_discrete = False

    #: "real" | "positive" | "unit_interval" | "discrete" | "other": picks the
    #: default unconstraining bijector (inference/transforms.py)
    support = "real"

    #: the standard variates ``_from_standard`` finishes, "normal" or
    #: "uniform"; None: no lane form (``sample_lanes`` raises)
    standard = None

    def logpdf(self, x, params):
        """log p(x; params), elementwise over leading batch axes."""
        return self._logpdf(x, *as_param_tuple(params))

    def sample(self, gen, params, dtype=None):
        """x ~ p(.; params), with the parameters' own batch shape."""
        params = as_param_tuple(params)
        return self._sample(gen, (), _sample_dtype(params, dtype), *params)

    def sample_batch(self, gen, shape, params, dtype=None):
        """``shape`` iid draws from ONE generator's stream (a plate)."""
        params = as_param_tuple(params)
        return self._sample(gen, tuple(shape), _sample_dtype(params, dtype),
                            *params)

    def from_standard(self, z, params):
        """The draw that the standard variates ``z`` give at ``params``."""
        return self._from_standard(z, *as_param_tuple(params))

    def sample_lanes(self, key_lanes, params, dtype=None, block=1):
        """One draw a lane, each from its lane's own stream: ``key_lanes``
        is a (C,) tensor of lane keys (core/keys.py). Parameters with a
        lane axis (``batched``) give draws of their own shape; shared ones
        give ``(C,)`` + their shape. The standard variates of a lane's draw
        depend only on its key and its shape, never on C.

        With ``block`` > 1 each key serves a block of that many consecutive
        lanes (C * block in all), drawn from the key's stream as one
        ``(block,) + shape`` plate: the batched tier's one stream a site,
        once a chain (inference/blocked_smc.py)."""
        if self.standard is None:
            raise NotImplementedError(f"{self!r}: {LANE_TODO}")
        params = as_param_tuple(params)
        dtype = _sample_dtype(params, dtype)
        shape = self._lane_shape(params)
        c = key_lanes.shape[0] * block
        if not self.batched(params):
            shape = (c,) + shape
        elif shape[:1] != (c,):
            raise ValueError(f"{self!r}: parameters of shape {shape} have "
                             f"no leading axis of the {c} lanes")
        return self._from_standard(
            standard_lanes(self.standard, key_lanes, shape[1:], dtype, block),
            *params)

    def _lane_shape(self, params):
        """One draw's shape at ``params``, a lane axis included."""
        return tuple(torch.broadcast_shapes(*(shape_of(p) for p in params)))

    def batched(self, params):
        """True if a parameter carries a batch axis beyond the event rank:
        such a site cannot share one plate draw across particles."""
        return any(torch.is_tensor(p) and p.ndim > self.event_rank
                   for p in as_param_tuple(params))

    def _logpdf(self, x, *params):
        raise NotImplementedError

    def _sample(self, gen, shape, dtype, *params):
        raise NotImplementedError

    def _from_standard(self, z, *params):
        raise NotImplementedError(
            f"{type(self).__name__}: no standard-draw form")

    def __repr__(self):
        return type(self).__name__
