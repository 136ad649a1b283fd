"""Importance sampling and importance resampling (counterpart of
modppl_tpu/inference/importance.py).

``vectorized=True`` is one generate over a leading lane axis of
``num_samples`` lanes: a ``Gen`` runs its body once through the batched
tier (modeling/autobatch.py, the reference's ``vmap``), a hand-coded GenFn
through its own ``batch_generate``; a GenFn without one raises. The
returned traces are then ONE batched trace: every value, log-probability,
return value and ``logjp`` has the lane axis first (the constraints are
broadcast to it as views), its ``args`` are the call's; ``tree_index``
takes one trace out. ``vectorized=False`` is the reference's loop of
``num_samples`` generates, one key each, for models that branch on their
draws on the host, and returns a list of traces.

Entry points run on ``device``: the card unless the caller passes
``device="cpu"``; the model's tensor arguments and the constraints are
moved there. ``pool`` (vectorized) maps addresses to pre-drawn
(num_samples, ...) values that replace the lanes' draws, so a test can
hand both sides the same lanes.
"""

import math

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.gfi import Trace
from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import categorical
from modppl_tpu_torch.modeling.autobatch import _lane_generate
from modppl_tpu_torch.modeling.gen import Gen
from modppl_tpu_torch.modeling.handlers import (
    entry_device,
    infer_dtype_device,
    to_device,
)
from modppl_tpu_torch.utils.numerics import logsumexp


def tree_index(tree, i):
    """Element ``i`` of a batched trace (or any pytree of lane-major
    tensors): every tensor with a leading axis is indexed, the rest (a
    trace's ``args``, host numbers) kept."""
    take = lambda x: x[i] if torch.is_tensor(x) and x.ndim else x  # noqa: E731
    if isinstance(tree, Trace):
        return Trace(tree.args, tree_index(tree.data, i),
                     tree_index(tree.retv, i), take(tree.logjp))
    if isinstance(tree, Trie):
        t = tree.map(take)
        for node in t._nodes():
            node.logp = take(node.logp)
        return t
    return pytree.tree_map(take, tree)


def _lanes(constraints, n, dtype, device):
    """The constraints broadcast to ``n`` lanes, as views."""
    def lanes(v):
        v = torch.as_tensor(v, device=device,
                            dtype=dtype if isinstance(v, float) else None)
        return v.expand((n,) + tuple(v.shape))
    return constraints.map(lanes)


def _batched_generate(key, model, args, constraints, n, device, pool):
    if isinstance(model, Gen):
        args = args if isinstance(args, tuple) else (args,)
        dtype, device = infer_dtype_device(args, device)
        return _lane_generate(model, key, args,
                              _lanes(constraints, n, dtype, device), n,
                              pool=pool, device=device)
    if not hasattr(model, "batch_generate"):
        raise TypeError(
            f"importance_sampling: {model!r} has no batch_generate, so it "
            f"cannot run vectorized; pass vectorized=False to run one "
            f"generate a sample")
    return model.batch_generate(key, args, constraints, n, device=device,
                                pool=pool)


def importance_sampling(key, model, model_args, constraints, num_samples,
                        vectorized=True, device=None, pool=None):
    """N-sample importance sampling with the model's internal proposal.

    Returns (traces, log_normalized_weights (N,), log_ml_estimate), where
    log_ml_estimate = logsumexp(log weights) - ln N."""
    device = entry_device(device, "importance_sampling")
    model_args = to_device(model_args, device)
    constraints = to_device(constraints, device)
    if vectorized:
        traces, log_weights = _batched_generate(
            key, model, model_args, constraints, num_samples, device, pool)
        log_weights = torch.as_tensor(log_weights, device=device).expand(
            num_samples)
    else:
        out = [model.generate(k, model_args, constraints, device=device)
               for k in split(key, num_samples)]
        traces = [t for t, _ in out]
        log_weights = torch.stack([torch.as_tensor(w, device=device)
                                   for _, w in out])
    log_total_weight = logsumexp(log_weights)
    log_ml_estimate = log_total_weight - math.log(num_samples)
    return traces, log_weights - log_total_weight, log_ml_estimate


def importance_resampling(key, model, model_args, constraints, num_samples,
                          num_ret_samples, vectorized=True, device=None,
                          pool=None):
    """Importance sampling, then ``num_ret_samples`` trace indices drawn
    by the normalized weights (the large-K arm of ``categorical``).

    Returns (traces, resampled_indices (int32), log_ml_estimate)."""
    k_is, k_res = split(key)
    traces, log_normalized_weights, log_ml_estimate = importance_sampling(
        k_is, model, model_args, constraints, num_samples,
        vectorized=vectorized, device=device, pool=pool)
    weights = torch.exp(log_normalized_weights)
    resampled_indices = categorical.sample_batch(
        generator(k_res, weights.device), (num_ret_samples,), (weights,))
    return traces, resampled_indices, log_ml_estimate
