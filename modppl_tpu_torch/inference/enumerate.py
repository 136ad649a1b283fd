"""Exact enumerative inference over finite-support latents (counterpart of
modppl_tpu/inference/enumerate.py).

Each enumerated address is constrained to every value of its support,
jointly with the observations; the fully constrained generate weight is
the log joint. The reference scores the support grid with a ``vmap`` of
``assess``; the port scores the whole flattened grid in ONE batched
generate (modeling/autobatch.py), one lane a grid point, as importance
sampling runs its lanes. Continuous latents must be observed or enumerated
on a grid the caller supplies (a Riemann-sum marginal).
"""

import torch

from modppl_tpu_torch.inference.importance import _lanes
from modppl_tpu_torch.modeling.autobatch import _lane_generate
from modppl_tpu_torch.modeling.gen import Gen
from modppl_tpu_torch.modeling.handlers import (
    entry_device,
    entry_inputs,
    infer_dtype_device,
)
from modppl_tpu_torch.utils.numerics import logsumexp


def support_of(dist, params, device=None):
    """Finite support of a discrete distribution as a tensor on ``device``
    (the card unless the caller names one), or None. Knows bernoulli
    {False, True}, uniform_discrete [a, b] and categorical [0, k)."""
    from modppl_tpu_torch.dists.scalar import (
        Bernoulli,
        Categorical,
        UniformDiscrete,
    )

    params = params if isinstance(params, tuple) else (params,)
    if isinstance(dist, Bernoulli):
        return torch.tensor([False, True],
                            device=entry_device(device, "support_of"))
    if isinstance(dist, UniformDiscrete):
        a, b = params
        return torch.arange(int(a), int(b) + 1,
                            device=entry_device(device, "support_of"))
    if isinstance(dist, Categorical):
        (probs,) = params
        return torch.arange(probs.shape[-1],
                            device=entry_device(device, "support_of"))
    return None


def enumerate_posterior(model, args, observed, supports, device=None):
    """Score every combination of the given latent supports exactly.

    ``model`` is a ``@gen`` model whose body takes a leading lane axis
    (every port model written for the batched tier does); ``observed`` is
    the observations' Trie; ``supports`` maps every latent address to a 1-D
    tensor of candidate values. Runs on ``device``: the card unless the
    caller passes ``device="cpu"``.

    Returns a dict: ``addrs`` (the enumerated addresses, in ``supports``'
    order), ``grid`` ({addr: that address's value per combination}),
    ``log_joint`` (num_combos,), ``log_ml`` (its logsumexp, exact when the
    supports are exhaustive), ``log_posterior`` and ``marginals`` ({addr:
    posterior probabilities aligned with ``supports[addr]``}).
    """
    if not isinstance(model, Gen):
        raise TypeError(f"enumerate_posterior: {model!r} is not a @gen "
                        "model; the grid is scored as one batched generate")
    device, args, observed = entry_inputs(device, args, observed,
                                          "enumerate_posterior")
    addrs = tuple(supports)
    axes = [torch.as_tensor(supports[a]).to(device) for a in addrs]
    # the grid by index (torch.meshgrid takes one dtype; supports differ)
    idx = torch.meshgrid(*(torch.arange(len(ax), device=device)
                           for ax in axes), indexing="ij")
    flat = [ax[i.reshape(-1)] for ax, i in zip(axes, idx)]
    n = flat[0].shape[0]
    dtype, _ = infer_dtype_device(args, device)
    constraints = _lanes(observed, n, dtype, device)
    for a, v in zip(addrs, flat):
        constraints.observe(a, v)
    # every address constrained: the weight is the log joint
    _, log_joint = _lane_generate(model, 0, args, constraints, n,
                                  device=device)
    log_ml = logsumexp(log_joint)
    log_post = log_joint - log_ml
    post_grid = torch.exp(log_post).reshape(tuple(len(ax) for ax in axes))
    marginals = {}
    for i, a in enumerate(addrs):
        other = tuple(j for j in range(len(addrs)) if j != i)
        marginals[a] = torch.sum(post_grid, dim=other) if other else post_grid
    return {
        "addrs": addrs,
        "grid": dict(zip(addrs, flat)),
        "log_joint": log_joint,
        "log_ml": log_ml,
        "log_posterior": log_post,
        "marginals": marginals,
    }


def auto_supports(model, args, observed, key=0, device=None):
    """Infer finite supports for every non-observed discrete address.

    Generates the model once to find its addresses and the distribution
    recorded on each leaf, then maps each non-observed discrete address to
    its support (on ``device``: the card unless the caller names one).
    Raises when a non-observed address has no finite support known without
    its parameters (only bernoulli's is): pass those in ``supports``
    explicitly, or observe them. Valid only for models whose address
    structure and parameters do not depend on the enumerated values.
    """
    device, args, on_device = entry_inputs(device, args, observed,
                                           "auto_supports")
    trace, _ = model.generate(key, args, on_device, device=device)
    sup = {}
    for addr in trace.data.addresses():
        if observed.search(addr) is not None:
            continue
        node = trace.data.search(addr)
        if node.dist is None:
            continue  # a sub-model's return value, not a choice
        try:
            s = support_of(node.dist, (), device=device)
        except (ValueError, TypeError):
            s = None
        if s is None:
            raise ValueError(
                f'enumerate: address "{addr}" (dist {node.dist!r}) has no '
                "inferable finite support; pass it in `supports` explicitly")
        sup[addr] = s
    return sup
