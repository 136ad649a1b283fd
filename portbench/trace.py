"""What the profiler saw over a few units, reduced to what the per-layer
readers and the result's ``breakdown`` need.

``capture(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) and returns a ``Profile``: every device operation (kernel,
copy, set) with its start and end, and every host event. Times are in
seconds from the profile's first event.
"""

import re

import torch

from portbench.loader import REPO


class Profile:
    """Device operations ``ops`` [(name, start, end)] and host events
    ``host`` [(name, start, end)], both sorted by start, over the window
    ``[0, window_s]`` that spans every event."""

    def __init__(self, ops, host, units):
        t0 = min([s for _, s, _ in ops] + [s for _, s, _ in host], default=0.0)
        by_start = lambda ev: (ev[1], ev[2])  # noqa: E731
        self.ops = sorted(((n, s - t0, e - t0) for n, s, e in ops),
                          key=by_start)
        self.host = sorted(((n, s - t0, e - t0) for n, s, e in host),
                           key=by_start)
        self.units = units
        ends = [e for _, _, e in self.ops] + [e for _, _, e in self.host]
        self.window_s = max(ends, default=0.0)

    def busy_intervals(self):
        """The union of the device operations' intervals."""
        out = []
        for _, s, e in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals())

    def op_seconds(self, match=None):
        """Total device seconds of the operations whose name ``match``
        (a callable) accepts, all of them for None."""
        return sum(e - s for n, s, e in self.ops
                   if match is None or match(n))

    def op_count(self):
        return len(self.ops)

    def top_ops(self, k=10):
        """[name, seconds] of the ``k`` operations that took the most
        device time, summed by name."""
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n[:80], v] for n, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k=10):
        """[what the host was doing, seconds] of the ``k`` longest spans of
        the window with no device operation: the innermost host event open
        at the gap's start, else "host"."""
        gaps, prev = [], 0.0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = e
        if self.window_s > prev:
            gaps.append((prev, self.window_s))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            name = "host"
            for n, hs, he in self.host:
                if hs > s:
                    break
                if he > s:
                    name = n  # later starts are nested deeper
            out.append([name[:80], e - s])
        return out


def capture(fn, units):
    """Profile ``fn()`` (which runs ``units`` units and synchronizes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    ops, host = [], []
    for ev in prof.events():
        span = (ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(span)
        else:
            host.append(span)
    return Profile(ops, host, units)


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)")


def program_kernels(package="modppl_tpu_torch"):
    """The names of the kernels the program's own sources define: each
    ``__global__`` function of its ``.cu`` / ``.cuh`` files and each
    ``@triton.jit`` function of its Python files."""
    names = set()
    root = REPO / package
    for path in sorted(root.rglob("*")):
        if "probes" in path.parts or not path.is_file():
            continue
        if path.suffix in (".cu", ".cuh"):
            names.update(_GLOBAL.findall(path.read_text()))
        elif path.suffix == ".py":
            names.update(_TRITON.findall(path.read_text()))
    return names


def symbol_matcher(names):
    """A predicate: does a device operation's (demangled) name call one of
    ``names``, as ``ns::name<...>(...)`` or ``name(...)``?"""
    if not names:
        return lambda _: False
    pat = re.compile(r"(?:^|[\s:*&])(?:" + "|".join(
        re.escape(n) for n in sorted(names)) + r")\s*[<(]")
    return lambda op: bool(pat.search(op)) or op in names
