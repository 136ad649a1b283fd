"""Map: a generative function applied independently across a plate
(counterpart of modppl_tpu/modeling/map_combinator.py).

    plate = Map(obs_point_model)
    ys = h.trace(plate, (slopes, xs), "ys")   # leaves carry the plate axis

The reference ``vmap``s the kernel's GFI over the plate axis with
``split(key, n)`` keys. The port runs the kernel's body ONCE over the plate
axis as lanes (modeling/handlers.py): element j is keyed by the lane key
``split(key, n)[j]`` (core/keys.py), so its draws are those of its key
alone. The Map's sub-trie (``PlateTrie``) holds every value with the plate
axis and one log-probability an element; its ``weight`` sums the plate, so
the parent scores the plate as one call, and the weights and ``logjp`` of
the four GFI operations are summed over it, as the reference's are.

Nested in a lane-batched model (a tensor of C lane keys, the reference's
``vmap`` of runs), the plate runs as C n lanes, lane c's element j keyed
``split(keys[c], n)[j]``, and the trace's leaves come back (C, n, ...).
Which arguments the lanes share is stated, not read from shapes:
``Map(kernel, shared=(i, ...))`` names the positional arguments whose
leaves are (n, ...) for every lane (the reference's ``vmap`` leaves them
unmapped); every other argument's leaves are per lane, (C, n, ...), and
a leaf of another shape raises. A constraint or pool leaf of shape
(C, n, ...) is per lane, which always states it; one of any other shape
(n, ...) is shared. So when C == n, a shared leaf with a second axis of n
must be passed broadcast to (C, n, ...).
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.gfi import GenFn, Trace
from modppl_tpu_torch.core.keys import fold_in_lanes, split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists.base import Standard
from modppl_tpu_torch.modeling.handlers import infer_dtype_device


class PlateTrie(Trie):
    """A Map's choice trie: values and log-probabilities carry the plate
    axis last among the leading ones (n,) or (C, n); ``weight`` sums it."""

    __slots__ = ()

    def weight(self):
        w = Trie.weight(self)
        return w.sum(-1) if torch.is_tensor(w) and w.ndim else w


def _convert(trie, value_fn, logp_fn, root_cls):
    """A copy of ``trie`` whose root is a ``root_cls`` and whose tensor
    values and log-probabilities went through the two functions."""
    t = root_cls()
    if trie.has_inner():
        t.value = value_fn(trie.value)
    t.logp = logp_fn(trie.logp)
    t.dist = trie.dist
    t.children = {k: _convert(v, value_fn, logp_fn, type(v))
                  for k, v in trie.children.items()}
    return t


class _Plate:
    """A call's plate: its size ``n``, the lane count ``c`` (None for a
    host key), the ``m`` lane keys the kernel runs over and the maps
    between the caller's leaves and the kernel's (m, ...) lanes."""

    def __init__(self, key, args, device, shared):
        lane = torch.is_tensor(key)
        self.c = key.shape[0] if lane else None
        # (leaf, shared by the lanes) for every tensor leaf of the args
        tagged = [(x, not lane or i in shared)
                  for i, a in enumerate(args)
                  for x in pytree.tree_leaves(a) if torch.is_tensor(x)]
        if not tagged:
            raise ValueError("Map: args must contain a tensor leaf with the "
                             "plate axis")
        first, first_shared = tagged[0]
        axis = 0 if first_shared else 1
        if first.ndim <= axis:
            raise ValueError(f"Map: a leaf of shape {tuple(first.shape)} has "
                             f"no plate axis")
        self.n = first.shape[axis]
        if device is None and lane:
            device = key.device
        self.dtype, self.device = infer_dtype_device(args, device)
        if lane:
            j = torch.arange(self.n, dtype=torch.int64,
                             device=key.device) + (1 << 32)
            self.keys = fold_in_lanes(key[:, None], j).reshape(-1)
        else:
            self.keys = split_keys(key, self.n, self.device)
        self.m = self.keys.shape[0]
        self.args = tuple(
            pytree.tree_map(lambda x, s=(i in shared): self.lanes(x, s), a)
            for i, a in enumerate(args))

    def lanes(self, x, shared=None):
        """A caller's leaf as the kernel's: (C, n, ...) or a shared
        (n, ...) as (C n, ...); non-tensors as they are. ``shared`` says
        which the leaf is; None (a trie's leaf) takes (C, n, ...) as per
        lane and any other (n, ...) as shared."""
        if not torch.is_tensor(x):
            return x
        c, n = self.c, self.n
        if c is None:
            if x.ndim == 0 or x.shape[0] != n:
                raise ValueError(f"Map: a leaf of shape {tuple(x.shape)} has "
                                 f"no plate axis of size {n}")
            return x
        per_lane = x.ndim >= 2 and tuple(x.shape[:2]) == (c, n)
        is_shared = x.ndim >= 1 and x.shape[0] == n
        if per_lane and not shared:
            return x.reshape((c * n,) + tuple(x.shape[2:]))
        if is_shared and shared is not False:
            return x.expand((c,) + tuple(x.shape)).reshape(
                (c * n,) + tuple(x.shape[1:]))
        want = {None: f"neither per lane ({c}, {n}, ...) nor shared "
                      f"({n}, ...)",
                True: f"not shared ({n}, ...)",
                False: f"not per lane ({c}, {n}, ...)"}[shared]
        raise ValueError(f"Map: a leaf of shape {tuple(x.shape)} is {want}")

    def unlanes(self, x):
        """A kernel's (C n, ...) leaf as the caller's (C, n, ...)."""
        if (self.c is None or not torch.is_tensor(x) or x.ndim == 0
                or x.shape[0] != self.m):
            return x
        return x.reshape((self.c, self.n) + tuple(x.shape[1:]))

    def per_lane(self, w):
        """A weight or log-probability with one value a lane, (m,)."""
        if torch.is_tensor(w) and w.ndim and w.shape[0] == self.m:
            return w
        return torch.zeros(self.m, dtype=self.dtype, device=self.device) + w

    def kernel_trie(self, trie, shared=None):
        """A caller's trie (constraints, or with ``shared=False`` a previous
        Map sub-trie, per lane) as the kernel's plain Trie over the lanes,
        its root value dropped."""
        def lanes(x):
            return self.lanes(x, shared)
        t = _convert(trie, lanes, lanes, Trie)
        t.take_inner()
        return t

    def plate_trie(self, trie):
        """A kernel's trie as the caller's ``PlateTrie``."""
        def logp(lp):
            if not torch.is_tensor(lp) and lp == 0:
                return lp
            return self.unlanes(self.per_lane(lp))
        return _convert(trie, self.unlanes, logp, PlateTrie)

    def total(self, w):
        """The kernel's per-lane weight summed over the plate."""
        return self.unlanes(self.per_lane(w)).sum(-1)

    def pool(self, pool):
        if not pool:
            return None
        return {a: (Standard(self.lanes(v.z)) if isinstance(v, Standard)
                    else self.lanes(v)) for a, v in pool.items()}

    def trace(self, args, tr):
        data = self.plate_trie(tr.data)
        return Trace(args, data, pytree.tree_map(self.unlanes, tr.retv),
                     data.weight())


class Map(GenFn):
    """Apply ``kernel`` independently across the plate axis of its args
    (see the module docstring); under lane keys the positional args
    numbered in ``shared`` are the lanes' common (n, ...) data."""

    def __init__(self, kernel, shared=()):
        self.kernel = kernel
        self.shared = frozenset(shared)

    def __repr__(self):
        return f"Map({self.kernel!r})"

    def simulate(self, key, args, device=None, pool=None):
        p = _Plate(key, args, device, self.shared)
        tr = self.kernel.simulate(p.keys, p.args, device=p.device,
                                  pool=p.pool(pool))
        return p.trace(args, tr)

    def generate(self, key, args, constraints, device=None, pool=None):
        p = _Plate(key, args, device, self.shared)
        tr, w = self.kernel.generate(p.keys, p.args,
                                     p.kernel_trie(constraints),
                                     device=p.device, pool=p.pool(pool))
        return p.trace(args, tr), p.total(w)

    def update(self, key, trace, args, argdiff, constraints, device=None,
               pool=None):
        p = _Plate(key, args, device, self.shared)
        prev = Trace(p.args, p.kernel_trie(trace.data, False), None,
                     0.0)
        tr, discard, w = self.kernel.update(
            p.keys, prev, p.args, argdiff, p.kernel_trie(constraints),
            device=p.device, pool=p.pool(pool))
        return p.trace(args, tr), p.plate_trie(discard), p.total(w)

    def regenerate(self, key, trace, args, argdiff, selection, device=None,
                   pool=None):
        p = _Plate(key, args, device, self.shared)
        prev = Trace(p.args, p.kernel_trie(trace.data, False), None,
                     0.0)
        tr, w = self.kernel.regenerate(p.keys, prev, p.args, argdiff,
                                       selection, device=p.device,
                                       pool=p.pool(pool))
        return p.trace(args, tr), p.total(w)
