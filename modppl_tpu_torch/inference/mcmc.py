"""MCMC kernels by selection (counterpart of modppl_tpu/inference/mcmc.py:
17-70).

A kernel maps ``(key, trace) -> (trace, accepted)``. The accept/reject is
``tree_select``, an elementwise select over the two traces, so one kernel
serves one trace or a batched trace whose leaves carry a leading particle
axis: then the weight, the accept uniform and the decision are per
particle, and nothing is read on the host. ``mcmc_chains`` (one chain per
key under vmap in the reference) is not ported: it needs one key stream per
chain (ROADMAP Queue 1 item 8b).
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.gfi import ArgDiff, Trace
from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.core.trie import Trie


def _where(pred, x, y):
    """``x`` where ``pred`` else ``y``, with ``pred``'s axes leading."""
    if x is y:
        return x
    if not torch.is_tensor(x) and not torch.is_tensor(y):
        if x == y:
            return x
    if torch.is_tensor(pred) and pred.ndim:
        nd = max(torch.as_tensor(x).ndim, torch.as_tensor(y).ndim)
        pred = pred.reshape(pred.shape + (1,) * (nd - pred.ndim))
    return torch.where(pred, x, y)


def _select_trie(pred, a, b):
    if set(a.children) != set(b.children) or a.has_inner() != b.has_inner():
        raise ValueError("tree_select: the two traces differ in structure")
    t = Trie()
    t.dist = a.dist
    if a.has_inner():
        t.value = _where(pred, a.value, b.value)
    t.logp = _where(pred, a.logp, b.logp)
    t.children = {k: _select_trie(pred, sub, b.children[k])
                  for k, sub in a.children.items()}
    return t


def tree_select(pred, a, b):
    """The trace ``a`` where ``pred`` else ``b``: every leaf's value and
    log-probability, the return value and ``logjp``, elementwise. The two
    traces must have one structure."""
    return Trace(a.args, _select_trie(pred, a.data, b.data),
                 pytree.tree_map(lambda x, y: _where(pred, x, y), a.retv,
                                 b.retv),
                 _where(pred, a.logjp, b.logjp))


def accept_uniform(key, like):
    """The accept uniforms, one per element of ``like`` (the log acceptance
    ratio), from ``key``'s stream on ``like``'s device."""
    like = torch.as_tensor(like)
    g = generator(key, like.device)
    return torch.rand(like.shape, generator=g, device=like.device,
                      dtype=like.dtype if like.is_floating_point()
                      else torch.get_default_dtype())


def accept_test(key, alpha, u=None):
    """log u < ``alpha``, elementwise, u drawn from ``key`` unless given."""
    if u is None:
        u = accept_uniform(key, alpha)
    if not torch.is_tensor(alpha):
        alpha = torch.as_tensor(alpha, dtype=u.dtype, device=u.device)
    return torch.log(u) < alpha


def mh_kernel(model, proposal, proposal_args=()):
    """One proposal-MH transition: ``(key, trace) -> (trace, accepted)``;
    the proposal takes ``(trace, *proposal_args)``."""
    proposal_args = (proposal_args if isinstance(proposal_args, tuple)
                     else (proposal_args,))

    def kernel(key, trace):
        k_fwd, k_upd, k_bwd, k_acc = split(key, 4)
        fwd_choices, fwd_weight = proposal.propose(
            k_fwd, (trace,) + proposal_args)
        new_trace, discard, weight = model.update(
            k_upd, trace, trace.args, ArgDiff.NO_CHANGE, fwd_choices)
        bwd_weight = proposal.assess(k_bwd, (new_trace,) + proposal_args,
                                     discard)
        accept = accept_test(k_acc, weight - fwd_weight + bwd_weight)
        return tree_select(accept, new_trace, trace), accept

    return kernel


def regen_mh_kernel(model, selection):
    """One regenerative-MH transition over ``selection``: the regenerate
    weight is the log acceptance ratio."""

    def kernel(key, trace):
        k_regen, k_acc = split(key)
        new_trace, weight = model.regenerate(
            k_regen, trace, trace.args, ArgDiff.NO_CHANGE, selection)
        accept = accept_test(k_acc, weight)
        return tree_select(accept, new_trace, trace), accept

    return kernel


def mcmc_chain(key, kernel, trace0, num_iters, extract=None):
    """``num_iters`` transitions of ``kernel``: returns (final trace,
    samples, accepts), ``extract(trace)`` recorded each iteration (None
    without ``extract``) and the accepts stacked on a leading axis."""
    trace, samples, accepts = trace0, [], []
    for k in split(key, num_iters):
        trace, accept = kernel(k, trace)
        if extract is not None:
            samples.append(extract(trace))
        accepts.append(accept)
    stacked = (pytree.tree_map(lambda *xs: torch.stack(xs), *samples)
               if samples else None)
    return trace, stacked, torch.stack(accepts) if accepts else None
