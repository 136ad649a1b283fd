"""Batched-particle execution of per-particle ``@gen`` kernels (counterpart
of modppl_tpu/modeling/autobatch.py).

The JAX package runs the body per lane under ``vmap`` and finds the sites
that can share one plate draw by spotting batch tracers. Torch has no such
tracers, so the port's rule is explicit:

- the body runs ONCE, on tensors whose leading axis is the particle axis
  (models index the trailing axes: ``pol[..., 0]``);
- a site whose params carry no particle axis (``Distribution.batched`` is
  false) draws one ``(n,)`` plate with ``sample_batch`` from the address's
  own stream;
- a site whose params are per-particle draws elementwise from that stream.

``pool`` maps addresses to pre-drawn ``(n,)`` tensors that replace the
draw, as the reference's ``_lane_generate`` pool does; the parity tests
inject the reference's own plate draws through it.
"""

import torch

from modppl_tpu_torch.core.gfi import Trace
from modppl_tpu_torch.core.keys import generator
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.modeling.gen import run_generate
from modppl_tpu_torch.modeling.handlers import (
    GenerateHandler,
    addr_subkey,
    infer_dtype_device,
)


class BatchGenerateHandler(GenerateHandler):
    """GenerateHandler over ``n`` particles at once."""

    def __init__(self, key, trace, constraints, dtype, device, n, pool=None):
        super().__init__(key, trace, constraints, dtype, device)
        self.n = n
        self.pool = pool

    def _draw(self, dist, params, addr):
        if self.pool is not None and addr in self.pool:
            return self.pool[addr]
        g = generator(addr_subkey(self.key, addr), self.device)
        if dist.batched(params):
            return dist.sample(g, params, dtype=self.dtype)
        return dist.sample_batch(g, (self.n,), params, dtype=self.dtype)


def _lane_generate(gen_fn, key, args, constraints, n, pool=None):
    """``Gen.generate`` over all ``n`` particles with the batch handler.
    Returns (trace, weight) with a per-particle ``(n,)`` weight."""
    constraints = constraints.copy()
    constraints.take_inner()
    dtype, device = infer_dtype_device(args)
    g = BatchGenerateHandler(key, Trace(args, Trie(), None, 0.0), constraints,
                             dtype, device, n, pool=pool)
    trace, weight = run_generate(g, gen_fn.fn, args)
    if not torch.is_tensor(weight) or weight.ndim == 0:
        weight = torch.zeros(n, dtype=dtype, device=device) + weight
    return trace, weight


class AutoBatchedInit:
    """Batch-aware init: args ``(*per_particle_args, n)``."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch({inner.__name__})"

    def generate(self, key, args, constraints, pool=None):
        *a, n = args
        return _lane_generate(self.inner, key, tuple(a), constraints, n,
                              pool=pool)


class AutoBatchedStep:
    """Batch-aware step: args ``(t, state)`` with ``state`` batched on its
    leading axis."""

    def __init__(self, inner):
        self.inner = inner
        self.__name__ = f"auto_batch({inner.__name__})"

    def generate(self, key, args, constraints, pool=None):
        t, state = args
        return _lane_generate(self.inner, key, (t, state), constraints,
                              state.shape[0], pool=pool)


def auto_batch_scan_kernel(kernel):
    """A batched-particle ScanKernel from a per-particle one."""
    from modppl_tpu_torch.inference.vsmc import ScanKernel

    return ScanKernel(AutoBatchedInit(kernel.init),
                      AutoBatchedStep(kernel.step))
