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

Every distribution draws over lane keys (``sample_lanes``): one whose
``standard`` is "normal" or "uniform" finishes the lane's standard variates;
the others (``gamma``, ``beta``, ``poisson``, ``uniform_discrete`` and the
rejection samplers of dists/extra.py) draw by rejection over lanes
(``rejection_draw``, core/keys.rejection_lanes) or by a search of the CDF
(``cdf_search``), each from its lane's own words.
"""

import math

import torch

from modppl_tpu_torch.core.keys import (
    generator,
    normal_lanes,
    note_rounds,
    rejection_lanes,
    uniform_lanes,
    UNROLLED_ROUNDS,
)

#: steps of ``cdf_search`` between its host reads
SEARCH_STEPS = 8
#: a search still open after this many steps raises (every search here
#: stops within ~50: its pmf falls below an ulp of its CDF)
MAX_SEARCH_STEPS = 1024


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


def rejection_draw(key_lanes, shape, block, words, propose, *params,
                   unrolled=UNROLLED_ROUNDS):
    """``shape`` = (C * block,) + one lane's draw shape, drawn by
    rejection (core/keys.rejection_lanes): key i's stream gives lanes
    [i * block, (i + 1) * block) as one plate, as ``standard_lanes`` does.
    Tensor ``params`` broadcast to ``shape``."""
    c = key_lanes.shape[0]
    m = math.prod(shape) // max(c, 1)
    flat = tuple(torch.broadcast_to(p, shape).reshape(c, m)
                 if torch.is_tensor(p) else p for p in params)
    return rejection_lanes(key_lanes, m, words, propose, flat,
                           unrolled=unrolled).reshape(shape)


def cdf_search(u, p0, ratio, limit=None):
    """The least k >= 0 whose CDF reaches ``u``, elementwise: pmf(0) = p0,
    pmf(k) = pmf(k - 1) ratio(k), summed in order (a discrete inversion;
    float64 inputs). The search also stops where the pmf no longer moves
    the CDF and, with ``limit``, at k = limit. Every element steps at
    once, with a host read every SEARCH_STEPS steps; past MAX_SEARCH_STEPS
    it raises ``RuntimeError``."""
    k = torch.zeros_like(u)
    pk, s = p0, p0
    done = u <= s
    steps = 0
    while True:
        for _ in range(SEARCH_STEPS):
            k1 = k + 1.0
            pk1 = pk * ratio(k1)
            s1 = s + pk1
            stop = (u <= s1) | (s1 == s)
            if limit is not None:
                stop = stop | (k1 >= limit)
            go = ~done
            k = torch.where(go, k1, k)
            pk = torch.where(go, pk1, pk)
            s = torch.where(go, s1, s)
            done = done | stop
        steps += SEARCH_STEPS
        if bool(done.all()):  # the host read
            break
        if steps >= MAX_SEARCH_STEPS:
            raise RuntimeError(f"cdf_search: open after {steps} steps")
    note_rounds(lambda: k + 1, steps // SEARCH_STEPS)
    return k


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
    #: "uniform"; None: the lane form is the subclass's ``_draw_lanes``
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
        params = as_param_tuple(params)
        dtype = _sample_dtype(params, dtype)
        shape = self._lane_shape(params)
        c = key_lanes.shape[0] * block
        if not self.batched(params):
            shape = (c,) + shape
        elif shape[:1] != (c,):
            raise ValueError(f"{self!r}: parameters of shape {shape} have "
                             f"no leading axis of the {c} lanes")
        return self._draw_lanes(key_lanes, shape, dtype, block, *params)

    def _draw_lanes(self, key_lanes, shape, dtype, block, *params):
        """The lane draws of ``shape`` = (C * block,) + one lane's shape:
        the lanes' standard variates, finished by ``_from_standard``."""
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
