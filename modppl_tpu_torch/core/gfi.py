"""The Generative Function Interface (counterpart of modppl_tpu/core/gfi.py).

Every method takes an integer PRNG key first (core/keys.py), the port's
counterpart of a threefry key.
"""


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

    def __repr__(self):
        return (f"Trace(args={self.args!r}, retv={self.retv!r}, "
                f"logjp={self.logjp!r}, data={self.data!r})")


class GenFn:
    """Interface for functions that support the inference library."""

    def simulate(self, key, args):
        """Execute the generative function, returning a sampled Trace."""
        raise NotImplementedError

    def generate(self, key, args, constraints, device=None):
        """Execute consistent with ``constraints``; returns (trace, weight)."""
        raise NotImplementedError

    def assess(self, key, args, constraints, device=None):
        """Conditional log-probability of fully-proposed ``constraints``."""
        _, weight = self.generate(key, args, constraints, device=device)
        return weight
