"""Profiling hooks: trace annotations, trace capture, device timing and
cost reporting (counterpart of modppl_tpu/utils/profiling.py), in torch's
idiom: ``torch.profiler`` in place of ``jax.profiler``, CUDA
synchronization in place of ``block_until_ready``, the FLOP counter in
place of XLA's cost analysis, and a ``torch.fx`` graph in place of HLO.
"""

import contextlib
import functools
import os
import time

import torch
from torch.utils import _pytree as pytree


#: the profiler's range: a host-side one (record scope FUNCTION), as the
#: reference's ``jax.profiler.TraceAnnotation``. torch's public
#: ``record_function`` opens a user-scope range, which a CUDA profile also
#: reports as a device-side annotation among its device events; it stands
#: in only for a torch that lacks the host-side range.
_RANGE = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast",
                 None) or torch.profiler.record_function


@functools.cache
def _nvtx():
    return torch.cuda.is_available()


class annotate(contextlib.ContextDecorator):
    """``with annotate(name):`` (or ``@annotate(name)`` on a function) a
    named span on the profiler's host timeline and, with a CUDA device, an
    NVTX range of the same name.

    The span is a host range only: a CUDA profile gains no device event
    from it, and a kernel belongs to it when its launch falls inside it.
    With no profiler active it costs about 2.2 us of host time on an H100
    host (``record_function`` alone costs 7.8 us there), and nothing on
    the device: no synchronize, no copy."""

    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name
        self._range = None

    def __enter__(self):
        self._range = _RANGE(self.name)
        self._range.__enter__()
        if _nvtx():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        return self._range.__exit__(*exc)

    def _recreate_cm(self):
        # a decorated function opens a span of its own on every call
        return type(self)(self.name)


def host_to_device(data, dtype=None, device=None):
    """``torch.tensor(data, dtype=dtype, device=device)``: a host value
    copied to ``device``. On a CUDA device the host waits for the copy
    (the queue ahead of it drains first), so the copy runs inside a
    ``modppl.h2d`` span, and a profile counts these copies and the device
    idle they cause; on any other device no span opens."""
    if device is not None and torch.device(device).type == "cuda":
        with annotate("modppl.h2d"):
            return torch.tensor(data, dtype=dtype, device=device)
    return torch.tensor(data, dtype=dtype, device=device)


@contextlib.contextmanager
def capture_trace(log_dir):
    """Profile the enclosed block (CPU activity, and CUDA kernels when a
    CUDA device is present) and write its Chrome trace to
    ``<log_dir>/trace.json`` (view it in Perfetto or chrome://tracing).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))


def _wait(result):
    """Wait for the device work behind ``result``'s CUDA tensors."""
    if any(torch.is_tensor(x) and x.is_cuda
           for x in pytree.tree_leaves(result)):
        torch.cuda.synchronize()
    return result


def device_time(fn, *args, repeats=3, **kwargs):
    """Wall-clock ``fn(*args, **kwargs)`` after one warm-up call: the best
    of ``repeats`` timed calls, each closed by ``torch.cuda.synchronize()``
    when the result holds a CUDA tensor. Returns (result, best_seconds)."""
    result = _wait(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _wait(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return result, best


def compiled_cost(fn, *args, **kwargs):
    """``{"flops": n}``: the floating-point operations of one call of
    ``fn(*args, **kwargs)``, counted by ``torch.utils.flop_counter.
    FlopCounterMode`` (matmuls, convolutions and attention; elementwise ops
    count 0). The call runs. Torch reports no "bytes accessed", which XLA's
    cost analysis also gives."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


def hlo_text(fn, *args, **kwargs):
    """The text of ``torch.fx.symbolic_trace(fn)``'s graph: torch has no
    HLO, and this graph of the traced ops is the nearest view of what a
    call runs. The arguments are not used (symbolic tracing needs none)."""
    return str(torch.fx.symbolic_trace(fn).graph)
