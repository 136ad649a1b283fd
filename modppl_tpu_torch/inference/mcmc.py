"""MCMC kernels by selection (counterpart of modppl_tpu/inference/mcmc.py).

A kernel maps ``(key, trace) -> (trace, accepted)``. The accept/reject is
``tree_select``, an elementwise select over the two traces, so one kernel
serves one trace or a batched trace whose leaves carry a leading particle
axis: then the weight, the accept uniform and the decision are per
particle, and nothing is read on the host.

``mcmc_chains`` runs C chains as one batched trace, the reference's
``vmap`` of ``mcmc_chain``: chain i is keyed ``split(key, C)[i]`` by a lane
key (core/keys.py), and the kernel's propose, update, assess and
regenerate run the model's body once over the chain axis with those lane
keys (modeling/handlers.py), each weight and accept uniform per chain.
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.gfi import ArgDiff, Trace
from modppl_tpu_torch.core.keys import (
    generator,
    split,
    split_keys,
    split_lanes,
    uniform_lanes,
)
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


def _split(key, num):
    """``split`` of a host key, or of each lane of a tensor of lane keys."""
    if torch.is_tensor(key):
        return split_lanes(key, num).unbind(-1)
    return split(key, num)


def accept_uniform(key, like):
    """The accept uniforms, one per element of ``like`` (the log acceptance
    ratio), from ``key``'s stream on ``like``'s device; from each lane's
    own stream for a tensor of lane keys."""
    like = torch.as_tensor(like)
    dtype = (like.dtype if like.is_floating_point()
             else torch.get_default_dtype())
    if torch.is_tensor(key):
        return uniform_lanes(key, (), dtype)
    g = generator(key, like.device)
    return torch.rand(like.shape, generator=g, device=like.device,
                      dtype=dtype)


def accept_test(key, alpha, u=None):
    """log u < ``alpha``, elementwise, u drawn from ``key`` unless given."""
    if u is None:
        u = accept_uniform(key, alpha)
    if not torch.is_tensor(alpha):
        alpha = torch.as_tensor(alpha, dtype=u.dtype, device=u.device)
    return torch.log(u) < alpha


def mh_kernel(model, proposal, proposal_args=()):
    """One proposal-MH transition: ``(key, trace, draws=None) -> (trace,
    accepted)``; the proposal takes ``(trace, *proposal_args)``. ``draws``
    = (pool, u) replaces the proposal's draws (a ``pool=`` dict) and the
    accept uniform(s)."""
    proposal_args = (proposal_args if isinstance(proposal_args, tuple)
                     else (proposal_args,))

    def kernel(key, trace, draws=None):
        pool, u = draws if draws is not None else (None, None)
        k_fwd, k_upd, k_bwd, k_acc = _split(key, 4)
        # propose is simulate: (its choices, its log joint)
        fwd = proposal.simulate(k_fwd, (trace,) + proposal_args,
                                **({} if pool is None else {"pool": pool}))
        fwd_choices, fwd_weight = fwd.data, fwd.logjp
        new_trace, discard, weight = model.update(
            k_upd, trace, trace.args, ArgDiff.NO_CHANGE, fwd_choices)
        bwd_weight = proposal.assess(k_bwd, (new_trace,) + proposal_args,
                                     discard)
        accept = accept_test(k_acc, weight - fwd_weight + bwd_weight, u)
        return tree_select(accept, new_trace, trace), accept

    kernel.gen_fns = (model, proposal)
    return kernel


def regen_mh_kernel(model, selection):
    """One regenerative-MH transition over ``selection``: the regenerate
    weight is the log acceptance ratio. ``draws`` = (pool, u) as
    ``mh_kernel``'s."""

    def kernel(key, trace, draws=None):
        pool, u = draws if draws is not None else (None, None)
        k_regen, k_acc = _split(key, 2)
        new_trace, weight = model.regenerate(
            k_regen, trace, trace.args, ArgDiff.NO_CHANGE, selection,
            **({} if pool is None else {"pool": pool}))
        accept = accept_test(k_acc, weight, u)
        return tree_select(accept, new_trace, trace), accept

    kernel.gen_fns = (model,)
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


def mcmc_chains(key, kernel, traces0, num_iters, num_chains, extract=None,
                draws=None):
    """``num_chains`` chains of :func:`mcmc_chain` as one batched trace (the
    reference's ``vmap`` of it): ``traces0`` is a batched trace whose
    leaves carry the leading chain axis (e.g. ``model.generate(split_keys(k,
    C, device), args, obs)``). Chain i is keyed ``split(key, C)[i]`` and its
    iteration t ``split(k_i, num_iters)[t]``, as lane keys, so chain i's
    draws do not depend on C. The kernel's models must be ``@gen``
    functions whose body is elementwise over the chain axis (they run once
    over it); any other raises ``TypeError``. ``draws``, one ``(pool, u)``
    an iteration, replaces the kernel's draws. Returns (final traces,
    ``extract(trace)`` stacked (chains, iters, ...) or None, accepts
    (chains, iters)) on the traces' device.
    """
    from modppl_tpu_torch.modeling.gen import Gen

    others = [g for g in getattr(kernel, "gen_fns", (None,))
              if not isinstance(g, Gen)]
    if others:
        raise TypeError(
            f"mcmc_chains: {others} would not run over the chain axis; "
            "mh_kernel / regen_mh_kernel of @gen functions whose body is "
            "elementwise over it are batched (else run mcmc_chain a chain)")
    device = torch.as_tensor(traces0.logjp).device
    keys = split_lanes(split_keys(key, num_chains, device), num_iters)
    trace, samples, accepts = traces0, [], []
    for t in range(num_iters):
        trace, accept = kernel(keys[:, t], trace,
                               draws=None if draws is None else draws[t])
        if extract is not None:
            samples.append(extract(trace))
        accepts.append(accept)
    stacked = (pytree.tree_map(lambda *xs: torch.stack(xs, 1), *samples)
               if samples else None)
    return trace, stacked, torch.stack(accepts, 1) if accepts else None
