"""Metropolis-Hastings kernels over one trace (counterpart of
modppl_tpu/inference/mh.py).

The proposal is a GenFn whose args are ``(prev_trace, *proposal_args)``.
These kernels run eagerly over any GenFn, dynamic-structure models and
trans-dimensional moves included; the batched kernels, whose accept is an
elementwise select, are inference/mcmc.py's. Each transition reads its
accept decision on the host (one device sync on the card), as the
reference's eager kernels do (``if accept``): the next transition's trace
structure may depend on it. Keys, and so the device, come from the trace:
a transition runs where its trace's tensors are.
"""

from modppl_tpu_torch.core.gfi import ArgDiff
from modppl_tpu_torch.core.keys import split
from modppl_tpu_torch.inference.mcmc import accept_test


def _mh_terms(keys, model, trace, proposal, proposal_args,
              fwd_choices=None):
    """The terms of one proposal-MH transition from ``trace``: propose
    forward choices, update the model with them and assess the discard
    under the backward proposal. ``keys`` are (k_fwd, k_upd, k_bwd).
    Returns (new_trace, discard, weight, fwd_weight, bwd_weight); the log
    acceptance ratio is weight - fwd_weight + bwd_weight. ``fwd_choices``
    is for the parity tests only: given the reference's forward choices,
    they are scored (``assess``) instead of proposed."""
    k_fwd, k_upd, k_bwd = keys
    args = (trace,) + proposal_args
    if fwd_choices is None:
        fwd_choices, fwd_weight = proposal.propose(k_fwd, args)
    else:
        fwd_weight = proposal.assess(k_fwd, args, fwd_choices)
    new_trace, discard, weight = model.update(
        k_upd, trace, trace.args, ArgDiff.NO_CHANGE, fwd_choices)
    bwd_weight = proposal.assess(k_bwd, (new_trace,) + proposal_args,
                                 discard)
    return new_trace, discard, weight, fwd_weight, bwd_weight


def metropolis_hastings(key, model, trace, proposal, proposal_args=()):
    """One proposal-MH transition; returns (trace, accepted), accepted a
    Python bool: accept iff ln u < weight - fwd_weight + bwd_weight."""
    k_fwd, k_upd, k_bwd, k_acc = split(key, 4)
    proposal_args = (proposal_args if isinstance(proposal_args, tuple)
                     else (proposal_args,))
    new_trace, _, weight, fwd_weight, bwd_weight = _mh_terms(
        (k_fwd, k_upd, k_bwd), model, trace, proposal, proposal_args)
    if accept_test(k_acc, weight - fwd_weight + bwd_weight):
        return new_trace, True
    return trace, False


mh = metropolis_hastings


def regenerative_metropolis_hastings(key, model, trace, selection,
                                     pool=None):
    """One regenerative-MH transition over ``selection``: the regenerate
    weight is the log acceptance ratio. ``pool`` replaces the regenerated
    draws, as ``Gen.regenerate``'s does. Returns (trace, accepted)."""
    k_regen, k_acc = split(key)
    kw = {} if pool is None else {"pool": pool}
    new_trace, weight = model.regenerate(
        k_regen, trace, trace.args, ArgDiff.NO_CHANGE, selection, **kw)
    if accept_test(k_acc, weight):
        return new_trace, True
    return trace, False


regen_mh = regenerative_metropolis_hastings
