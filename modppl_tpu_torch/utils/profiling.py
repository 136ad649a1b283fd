"""Profiling hooks: trace annotations, trace capture, device timing and
cost reporting (counterpart of modppl_tpu/utils/profiling.py), in torch's
idiom: ``torch.profiler`` in place of ``jax.profiler``, CUDA
synchronization in place of ``block_until_ready``, the FLOP counter in
place of XLA's cost analysis, and a ``torch.fx`` graph in place of HLO.
"""

import contextlib
import os
import time

import torch
from torch.utils import _pytree as pytree


@contextlib.contextmanager
def annotate(name):
    """A named span on the profiler's timeline (``torch.profiler.
    record_function``) and, with a CUDA device, an NVTX range of the same
    name; close to free outside an active trace."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
