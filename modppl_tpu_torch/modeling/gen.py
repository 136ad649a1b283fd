"""The ``@gen`` decorator (counterpart of modppl_tpu/modeling/gen.py).

A model is ``fn(h, *args)``; ``h.sample(dist, params, addr)`` is a random
choice. The body is written with torch ops, so it runs on whatever device
its argument tensors are on, or on the ``device`` the caller names (a model
with no tensor arguments must be given one).
"""

from modppl_tpu_torch.core.gfi import GenFn, Trace
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.modeling.handlers import GenerateHandler, infer_dtype_device


def _as_args_tuple(args):
    return args if isinstance(args, tuple) else (args,)


def run_generate(handler, fn, args):
    """Run ``fn`` under ``handler``, check that every constraint was
    consumed, and finish the trace (``logjp`` and ``retv``)."""
    retv = fn(handler, *args)
    if not handler.constraints.is_empty():
        raise ValueError(
            "generate error: not all constraints were consumed! residual: "
            f"{handler.constraints.addresses()}")
    trace = handler.tr
    trace.logjp = trace.data.weight()
    trace.set_retv(retv)
    return trace, handler.weight


class Gen(GenFn):
    """A generative function defined by a Python body over a handler."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", "gen_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __repr__(self):
        return f"Gen({self.__name__})"

    def generate(self, key, args, constraints, device=None):
        args = _as_args_tuple(args)
        constraints = constraints.copy()
        constraints.take_inner()  # in case constraints came from a proposal
        dtype, device = infer_dtype_device(args, device)
        g = GenerateHandler(key, Trace(args, Trie(), None, 0.0), constraints,
                            dtype, device)
        return run_generate(g, self.fn, args)

    def simulate(self, key, args, device=None):
        trace, _ = self.generate(key, args, Trie(), device=device)
        return trace


def gen(fn):
    """Decorator: turn ``fn(handler, *args)`` into a ``Gen``."""
    return Gen(fn)
