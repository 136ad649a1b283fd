"""The ``@gen`` decorator (counterpart of modppl_tpu/modeling/gen.py).

A model is ``fn(h, *args)``; ``h.sample(dist, params, addr)`` is a random
choice and ``h.trace(gen_fn, args, addr)`` a call of another generative
function. The body is written with torch ops, so it runs on whatever device
its argument tensors are on, or on the ``device`` the caller names (a model
with no tensor arguments must be given one; ``update`` and ``regenerate``
otherwise run on the previous trace's device).
"""

import torch

from modppl_tpu_torch.core.gfi import GenFn, Trace
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.modeling.handlers import (
    GenerateHandler,
    RegenerateHandler,
    SimulateHandler,
    UpdateHandler,
    infer_dtype_device,
)


def _as_args_tuple(args):
    return args if isinstance(args, tuple) else (args,)


def _residual_check(handler, what):
    if not handler.constraints.is_empty():
        raise ValueError(
            f"{what} error: not all constraints were consumed! residual: "
            f"{handler.constraints.addresses()}")


def _finish(handler, retv):
    trace = handler.tr
    trace.logjp = trace.data.weight()
    trace.set_retv(retv)
    return trace


def run_generate(handler, fn, args):
    """Run ``fn`` under a generate ``handler``, check that every constraint
    was consumed, and finish the trace (``logjp`` and ``retv``)."""
    retv = fn(handler, *args)
    _residual_check(handler, "generate")
    return _finish(handler, retv), handler.weight


def run_regenerate(handler, fn, args):
    """Run ``fn`` under a regenerate ``handler``, collect the unvisited
    addresses and finish the trace."""
    retv = fn(handler, *args)
    handler.gc()
    return _finish(handler, retv), handler.weight


def regenerate_mask(trace, selection):
    """The mask regenerate applies: an empty (leaf) selection means every
    address of the trace."""
    return trace.data.schema() if selection.is_leaf() else selection


def _trace_dtype_device(args, trace, device):
    """dtype and device of the arguments, else of the previous trace."""
    return infer_dtype_device(tuple(args) + (trace.data.values(),), device)


def _key_device(key, device):
    """A tensor of lane keys names the device when the caller does not."""
    return key.device if device is None and torch.is_tensor(key) else device


class Gen(GenFn):
    """A generative function defined by a Python body over a handler."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", "gen_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __repr__(self):
        return f"Gen({self.__name__})"

    def simulate(self, key, args, device=None, pool=None):
        args = _as_args_tuple(args)
        dtype, device = infer_dtype_device(args, _key_device(key, device))
        g = SimulateHandler(key, Trace(args, Trie(), None, 0.0), dtype,
                            device, pool=pool)
        return _finish(g, self.fn(g, *args))

    def generate(self, key, args, constraints, device=None, pool=None):
        args = _as_args_tuple(args)
        constraints = constraints.copy()
        constraints.take_inner()  # in case constraints came from a proposal
        dtype, device = infer_dtype_device(args, _key_device(key, device))
        g = GenerateHandler(key, Trace(args, Trie(), None, 0.0), constraints,
                            dtype, device, pool=pool)
        return run_generate(g, self.fn, args)

    def update(self, key, trace, args, argdiff, constraints, device=None,
               pool=None):
        args = _as_args_tuple(args)
        constraints = constraints.copy()
        constraints.take_inner()
        dtype, device = _trace_dtype_device(args, trace, device)
        # the handler edits the choice trie: copy it, so the caller's trace
        # (e.g. MH's previous trace) stays intact
        g = UpdateHandler(key, Trace(args, trace.data.copy(), trace.retv,
                                     trace.logjp),
                          argdiff, constraints, dtype, device, pool=pool)
        retv = self.fn(g, *args)
        g.gc()  # subtract the complement's weight, move it to the discard
        _residual_check(g, "update")
        return _finish(g, retv), g.discard, g.weight

    def regenerate(self, key, trace, args, argdiff, selection, device=None,
                   pool=None):
        args = _as_args_tuple(args)
        mask = regenerate_mask(trace, selection)
        dtype, device = _trace_dtype_device(args, trace, device)
        g = RegenerateHandler(key, Trace(args, trace.data.copy(), trace.retv,
                                         trace.logjp),
                              argdiff, mask, dtype, device, pool=pool)
        return run_regenerate(g, self.fn, args)


def gen(fn):
    """Decorator: turn ``fn(handler, *args)`` into a ``Gen``."""
    return Gen(fn)
