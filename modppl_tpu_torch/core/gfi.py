"""The Generative Function Interface (counterpart of modppl_tpu/core/gfi.py).

Every method takes an integer PRNG key first (core/keys.py), the port's
counterpart of a threefry key. Methods that may run a model with no tensor
arguments also take ``device``: the port does not fall back to the CPU.
"""

import enum


class ArgDiff(enum.Enum):
    """Incremental-update hint for ``update`` and ``regenerate``."""

    NO_CHANGE = "no_change"
    UNKNOWN = "unknown"
    # vector-valued data being appended (the reference's particle filter)
    EXTEND = "extend"


class Trace:
    """Record of one probabilistic execution: ``args``, ``data`` (the choice
    trie), ``retv`` and ``logjp`` (log joint probability)."""

    __slots__ = ("args", "data", "retv", "logjp")

    def __init__(self, args, data, retv, logjp):
        self.args = args
        self.data = data
        self.retv = retv
        self.logjp = logjp

    def set_retv(self, v):
        self.retv = v

    def copy(self):
        """A trace whose data can be edited apart from this one's: a
        Trie's structure is copied, a list's shallow-copied; tensors are
        shared."""
        data = self.data
        if hasattr(data, "copy"):
            data = data.copy()
        return Trace(self.args, data, self.retv, self.logjp)

    def __repr__(self):
        return (f"Trace(args={self.args!r}, retv={self.retv!r}, "
                f"logjp={self.logjp!r}, data={self.data!r})")


class GenFn:
    """Interface for functions that support the inference library."""

    def simulate(self, key, args, device=None):
        """Execute the generative function, returning a sampled Trace."""
        raise NotImplementedError

    def generate(self, key, args, constraints, device=None):
        """Execute consistent with ``constraints``; returns (trace, weight)."""
        raise NotImplementedError

    def update(self, key, trace, args, argdiff, constraints, device=None):
        """Update a trace with forward choices; returns (trace, discard,
        weight)."""
        raise NotImplementedError

    def regenerate(self, key, trace, args, argdiff, selection, device=None):
        """Regenerate a masked subset of a trace; returns (trace, weight)."""
        raise NotImplementedError("regenerate: impl not found")

    # -- derived methods ----------------------------------------------------

    def call(self, key, args, device=None):
        """Sample a trace and return its return value."""
        return self.simulate(key, args, device=device).retv

    def propose(self, key, args, device=None):
        """Sample (choices, logjp) from the function."""
        trace = self.simulate(key, args, device=device)
        return trace.data, trace.logjp

    def assess(self, key, args, constraints, device=None):
        """Conditional log-probability of fully-proposed ``constraints``."""
        _, weight = self.generate(key, args, constraints, device=device)
        return weight
