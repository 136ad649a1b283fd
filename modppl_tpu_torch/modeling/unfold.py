"""Unfold: the Markov-kernel combinator (counterpart of
modppl_tpu/modeling/unfold.py).

Wraps a kernel GenFn of ``(t, state) -> state`` as a GenFn of
``(T, state)`` whose data is the list of the T steps' choice tries and
whose return value is the list of the T states. ``t`` is a Python int, so
a kernel may branch on it (the spiral's ``t == 0`` arm). ``update`` takes
``ArgDiff.EXTEND`` only: it appends the new steps by ``generate`` and
returns one empty discard a step, the incremental extension the eager
particle filter (inference/smc.py) relies on. Step t's key is
``fold_in(key, t)``.
"""

from modppl_tpu_torch.core.gfi import ArgDiff, GenFn, Trace
from modppl_tpu_torch.core.keys import fold_in
from modppl_tpu_torch.core.trie import Trie


class Unfold(GenFn):
    """Sequential combinator over a kernel of args ``(t, state)``."""

    def __init__(self, kernel):
        self.kernel = kernel

    def __repr__(self):
        return f"Unfold({self.kernel!r})"

    def simulate(self, key, args, device=None):
        final_t, state = args
        assert final_t >= 1
        data, retv, logjp = [], [], 0.0
        for t in range(final_t):
            sub = self.kernel.simulate(fold_in(key, t), (t, state),
                                       device=device)
            state = sub.retv
            retv.append(state)
            data.append(sub.data)
            logjp = logjp + sub.logjp
        return Trace(args, data, retv, logjp)

    def _extend(self, key, t0, state, logjp, vec_constraints, device):
        """Generate steps t0, t0 + 1, ... under ``vec_constraints``: the
        new steps' (tries, states, ``logjp`` plus theirs, weight)."""
        data, retv, weight = [], [], 0.0
        for i, constraints in enumerate(vec_constraints):
            t = t0 + i
            sub, w = self.kernel.generate(fold_in(key, t), (t, state),
                                          constraints, device=device)
            state = sub.retv
            retv.append(state)
            data.append(sub.data)
            logjp = logjp + sub.logjp
            weight = weight + w
        return data, retv, logjp, weight

    def generate(self, key, args, vec_constraints, device=None):
        final_t, state = args
        assert final_t >= 1
        data, retv, logjp, weight = self._extend(key, 0, state, 0.0,
                                                 vec_constraints, device)
        return Trace(args, data, retv, logjp), weight

    def update(self, key, trace, args, argdiff, vec_constraints, device=None):
        final_t, _ = args
        assert final_t >= 1
        prev_t = trace.args[0]
        assert final_t - prev_t == len(vec_constraints)
        if argdiff is not ArgDiff.EXTEND:
            raise ValueError(f"Unfold.update: can't handle ArgDiff {argdiff}")
        data, retv, logjp, weight = self._extend(
            key, prev_t, trace.retv[-1], trace.logjp, vec_constraints, device)
        new_trace = Trace((final_t, trace.args[1]), list(trace.data) + data,
                          list(trace.retv) + retv, logjp)
        discard = [Trie() for _ in range(final_t - prev_t)]
        return new_trace, discard, weight
