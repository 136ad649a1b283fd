"""Batched-particle execution of per-particle ``@gen`` kernels (counterpart
of modppl_tpu/modeling/autobatch.py).

The JAX package runs the body per lane under ``vmap`` and finds the sites
that can share one plate draw by spotting batch tracers. Torch has no such
tracers, so the port's rule is explicit:

- the body runs ONCE, on tensors whose leading axis is the particle axis
  (models index the trailing axes: ``pol[..., 0]``);
- every site draws one value a particle, particle i from its own lane
  stream ``fold_in(addr_subkey(key, addr), i)`` (``Distribution.
  sample_lanes``), ``i`` its GLOBAL index: a shard holding the particles
  ``[offset, offset + n)`` draws exactly what one device draws for them,
  whatever the shard count (the reference gets this from partitionable
  threefry), and particle i's draws do not depend on N.

``pool`` maps addresses to pre-drawn ``(n,)`` tensors (or ``Standard``
draws) that replace the draw, as the reference's ``_lane_generate`` pool
does; the parity tests inject the reference's own draws through it.

The guided and rejuvenated filters add three entries: ``AutoBatchedPropose``
(the proposal's body once over the particle axis), the per-particle
constrained generate (``generate_constrained_batched``) and a batched
``regenerate``, whose handler draws as the generate handler does.
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.gfi import Trace
from modppl_tpu_torch.core.keys import lanes
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.modeling.gen import (
    Gen,
    regenerate_mask,
    run_generate,
    run_regenerate,
)
from modppl_tpu_torch.modeling.handlers import (
    GenerateHandler,
    RegenerateHandler,
    infer_dtype_device,
    pooled,
    sub_pool,
)


def _batch_draw(handler, dist, params, addr):
    """The draw at ``addr`` over ``handler.n`` particles: the pool's, else
    one value a particle from the lane keys ``particle_keys(addr)``. A
    (C,) tensor of chain keys gives each chain's block of n / C particles
    the address's stream of its own chain (``Distribution.sample_lanes``
    with ``block``)."""
    x = pooled(handler.pool, dist, params, addr)
    if x is not None:
        return x
    if torch.is_tensor(handler.key):
        keys = handler._subkey(addr)
        return dist.sample_lanes(keys, params, dtype=handler.dtype,
                                 block=handler.n // keys.shape[0])
    return dist.sample_lanes(handler.particle_keys(addr), params,
                             dtype=handler.dtype)


class _Particles:
    """The batched handlers' particles: ``n`` of them, from the global
    index ``offset``."""

    def particle_keys(self, addr):
        """(n,) lane keys at ``addr``: particle i's is
        ``fold_in(addr_subkey(key, addr), offset + i)``."""
        return lanes(self._subkey(addr), self.n, self.device,
                     offset=self.offset)


class BatchGenerateHandler(_Particles, GenerateHandler):
    """GenerateHandler over ``n`` particles at once, the first at the
    global index ``offset``. A call of another ``Gen`` runs its body over
    the same particles; a call of any other generative function (``Map``,
    ``Cond``, ...) runs it over the particles' lane keys at its address,
    one lane a particle."""

    def __init__(self, key, trace, constraints, dtype, device, n, pool=None,
                 offset=0):
        super().__init__(key, trace, constraints, dtype, device, pool=pool)
        self.n = n
        self.offset = offset

    def _draw(self, dist, params, addr):
        return _batch_draw(self, dist, params, addr)

    def _sub(self, addr):
        """A call of another generative function gets the particles' lane
        keys at ``addr`` (a (C,) tensor of chain keys: its own)."""
        key, kw = super()._sub(addr)
        return (key if torch.is_tensor(self.key)
                else self.particle_keys(addr)), kw

    def trace_call(self, gen_fn, args, addr):
        if not isinstance(gen_fn, Gen):
            return super().trace_call(gen_fn, args, addr)
        choices = self.constraints.remove(addr)
        subtrace, d_weight = _lane_generate(
            gen_fn, self._subkey(addr), args,
            Trie() if choices is None else choices, self.n,
            pool=sub_pool(self.pool, addr), device=self.device,
            offset=self.offset)
        if choices is not None:
            self.weight = self.weight + d_weight
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv


class BatchRegenerateHandler(_Particles, RegenerateHandler):
    """RegenerateHandler over ``n`` particles at once (the first at the
    global index ``offset``): a trace whose leaves carry the particle axis,
    per-particle weights. Its draws are kept in ``drawn``, for a filter's
    record."""

    def __init__(self, key, trace, diff, mask, dtype, device, n, pool=None,
                 offset=0):
        super().__init__(key, trace, diff, mask, dtype, device, pool=pool)
        self.n = n
        self.offset = offset
        self.drawn = {}

    def _draw(self, dist, params, addr):
        x = self.drawn[addr] = _batch_draw(self, dist, params, addr)
        return x


def _per_particle(x, n, dtype, device):
    """``x`` as an ``(n,)`` tensor (a weight that no site made per
    particle)."""
    if not torch.is_tensor(x) or x.ndim == 0:
        x = torch.zeros(n, dtype=dtype, device=device) + x
    return x


def _lane_generate(gen_fn, key, args, constraints, n, pool=None,
                   device=None, offset=0):
    """``Gen.generate`` over ``n`` particles with the batch handler, on
    ``device`` (else the arguments'), the first particle at the global
    index ``offset``. Returns (trace, weight) with a per-particle ``(n,)``
    weight."""
    constraints = constraints.copy()
    constraints.take_inner()
    dtype, device = infer_dtype_device(args, device)
    g = BatchGenerateHandler(key, Trace(args, Trie(), None, 0.0), constraints,
                             dtype, device, n, pool=pool, offset=offset)
    trace, weight = run_generate(g, gen_fn.fn, args)
    return trace, _per_particle(weight, n, dtype, device)


class AutoBatchedInit:
    """Batch-aware init: args ``(*per_particle_args, n)``."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch({inner.__name__})"

    def generate(self, key, args, constraints, pool=None, offset=0):
        *a, n = args
        return _lane_generate(self.inner, key, tuple(a), constraints, n,
                              pool=pool, offset=offset)


class AutoBatchedStep:
    """Batch-aware step: args ``(t, state)`` with ``state`` batched on its
    leading axis."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch({inner.__name__})"

    def generate(self, key, args, constraints, pool=None, offset=0):
        t, state = args
        return _lane_generate(self.inner, key, (t, state), constraints,
                              _num_particles(state), pool=pool,
                              offset=offset)

    def generate_constrained_batched(self, key, args, constraints_batched,
                                     pool=None, offset=0):
        """Generate with per-particle constraints: ``constraints_batched``
        carries leaves with a leading particle axis, the guided filter's
        proposed choices merged with the step's observations. The body runs
        once over the particle axis either way, so this is ``generate``."""
        return self.generate(key, args, constraints_batched, pool=pool,
                             offset=offset)

    def regenerate(self, key, trace, args, argdiff, selection, pool=None,
                   drawn=None, offset=0):
        """Regenerate ``selection`` in a batched trace: (trace, weight),
        the weight per particle. ``drawn``, a dict, receives the draws."""
        t, state = args
        n = _num_particles(state)
        dtype, device = infer_dtype_device(args)
        g = BatchRegenerateHandler(
            key, Trace(args, trace.data.copy(), trace.retv, trace.logjp),
            argdiff, regenerate_mask(trace, selection), dtype, device, n,
            pool=pool, offset=offset)
        new, weight = run_regenerate(g, self.inner.fn, args)
        if drawn is not None:
            drawn.update(g.drawn)
        return new, _per_particle(weight, n, dtype, device)


class AutoBatchedPropose:
    """Batched ``propose`` over a per-particle proposal Gen: the body runs
    once over the particle axis, ``propose(key, (t, state, *shared), n)``
    returning ``(choices, logjp)`` with every choice and ``logjp`` carrying
    the leading ``(n,)`` axis (propose is simulate, and simulate is
    generate with no constraints)."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch_propose({inner.__name__})"

    def propose(self, key, args, n, pool=None, offset=0):
        trace, _ = _lane_generate(self.inner, key, tuple(args), Trie(), n,
                                  pool=pool, offset=offset)
        dtype, device = infer_dtype_device(args)
        return trace.data, _per_particle(trace.logjp, n, dtype, device)


def _num_particles(state):
    return pytree.tree_leaves(state)[0].shape[0]


def auto_batch_scan_kernel(kernel):
    """A batched-particle ScanKernel from a per-particle one."""
    from modppl_tpu_torch.inference.vsmc import ScanKernel

    return ScanKernel(AutoBatchedInit(kernel.init),
                      AutoBatchedStep(kernel.step))
