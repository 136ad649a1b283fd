"""Structure combinators: ``Cond`` and ``Switch`` (counterpart of
modppl_tpu/modeling/combinators.py).

Each traces every branch under its own namespace and selects the return
value by the predicate or index, so the trace's ``logjp`` scores every
branch under its own prior: the inactive branches are proper auxiliary
variables, importance weights and MH ratios stay exact for the active one,
and the four GFI operations come from ``@gen``. The shapes are static,
so one generate serves a batch of lanes whichever branch each lane takes.

Under the port's batched and lane tiers the predicate or index carries a
leading lane axis (C,) while a branch's return value may carry more
axes; the select puts the predicate's axes first (``inference/mcmc.
_where``) and ``Switch`` gathers each lane's branch along the branch axis.
``tree_select`` here selects leaf by leaf in any tree; the trace-level
select of the MCMC kernels is ``inference/mcmc.tree_select``.
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.inference.mcmc import _where
from modppl_tpu_torch.modeling.gen import gen


def tree_select(pred, a, b):
    """Leafwise ``where(pred, a, b)`` over two trees of one structure; a
    tensor ``pred``'s axes lead (one value a lane), a Python bool picks a
    whole tree."""
    if not torch.is_tensor(pred):
        return a if pred else b
    pred = pred.to(torch.bool)
    return pytree.tree_map(lambda x, y: _where(pred, x, y), a, b)


def _take(index, *branches):
    """Each lane's branch: ``branches[index]``, leafwise; a (C,) index
    gathers lane c's value from branch ``index[c]``."""
    if not torch.is_tensor(index):
        return branches[int(index)]
    xs = torch.broadcast_tensors(*(torch.as_tensor(x, device=index.device)
                                   for x in branches))
    stacked = torch.stack(xs)
    idx = index.long()
    if idx.ndim == 0:
        return stacked[idx]
    idx = idx.reshape((1,) + tuple(idx.shape)
                      + (1,) * (stacked.ndim - 1 - idx.ndim))
    return torch.gather(stacked, 0, idx.expand((1,) + stacked.shape[1:]))[0]


def Cond(true_gen, false_gen, namespaces=("true", "false")):
    """Two-way stochastic branch: traces both, selects the return value by
    the predicate.

    Usage: ``h.trace(Cond(lin, quad), (pred, args), "branch")``; the
    sub-trace holds ``branch/true/...`` and ``branch/false/...``, and the
    two branches' return values must have one structure.
    """
    t_ns, f_ns = namespaces

    @gen
    def cond_fn(h, pred, args=()):
        rt = h.trace(true_gen, args, t_ns)
        rf = h.trace(false_gen, args, f_ns)
        return tree_select(pred, rt, rf)

    cond_fn.__name__ = (f"Cond({getattr(true_gen, '__name__', '?')}, "
                        f"{getattr(false_gen, '__name__', '?')})")
    return cond_fn


def Switch(*branch_gens):
    """N-way stochastic branch: traces every branch, selects the return
    value by index.

    Usage: ``h.trace(Switch(g0, g1, g2), (idx, args), "k")``; the
    namespaces are "0", "1", ... and the branches' return values must have
    one structure.
    """

    @gen
    def switch_fn(h, index, args=()):
        retvs = [h.trace(g, args, str(i)) for i, g in enumerate(branch_gens)]
        leaves = [pytree.tree_flatten(r)[0] for r in retvs]
        spec = pytree.tree_flatten(retvs[0])[1]
        return pytree.tree_unflatten(
            [_take(index, *xs) for xs in zip(*leaves)], spec)

    switch_fn.__name__ = f"Switch({len(branch_gens)})"
    return switch_fn
