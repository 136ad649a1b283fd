"""Parallel tempering, replica exchange over HMC / MALA chains (counterpart
of modppl_tpu/inference/tempering.py).

K replicas a chain run at inverse temperatures ``betas`` against

    pi_beta(u)  propto  prior(u) * likelihood(u)^beta,

interleaving within-replica moves with Metropolis swaps between adjacent
rungs, accepted with log alpha = (beta_i - beta_j)(loglik(u_j) -
loglik(u_i)), the pairings alternating even / odd each round.

Chains x replicas are one (C K, d) batch: a round's moves are one
``vmap(grad_and_value)`` call a leapfrog step over every replica of every
chain, each at its own beta, and the swaps one gather over the replica
axis. Chain c is keyed ``split(k_run, C)[c]`` and its round r, replica k,
move m by the reference's splits of that key, lane by lane (core/keys.py),
so a chain's run does not depend on C.
"""

import numpy as np
import torch

from modppl_tpu_torch.core.keys import (
    fold_in_lanes,
    normal_lanes,
    split,
    split_keys,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.inference.smc_sampler import (
    _tempered_hmc_move,
    _tempered_mala_move,
    _tempered_parts,
    tempered,
)
from modppl_tpu_torch.modeling.handlers import entry_inputs


def _swap_round(key_lanes, u, ll, betas, parity, us=None):
    """One even / odd swap sweep over the replica axis of every chain.

    u: (C, K, d) replicas; ll: (C, K) their log-likelihoods; parity 0 or
    1; ``us`` (C, K) replaces the uniforms drawn from each chain's key.
    Both members of a pair decide on the lower member's uniform. Returns
    the swapped (u, ll, accept (C, K))."""
    k = u.shape[1]
    idx = torch.arange(k, device=u.device)
    # partner of replica k in this parity round
    lower = (idx % 2 == parity) & (idx + 1 < k)
    partner = torch.where(lower, idx + 1, torch.where(
        (idx % 2 != parity) & (idx >= 1), idx - 1, idx))
    ll_p = ll[:, partner]
    log_alpha = (betas - betas[partner]) * (ll_p - ll)
    if us is None:
        us = uniform_lanes(key_lanes, (k,), u.dtype)
    pair_lo = torch.minimum(idx, partner)
    accept = (torch.log(us[:, pair_lo]) < log_alpha) & (partner != idx)
    src = torch.where(accept, partner, idx)
    return (torch.gather(u, 1, src[..., None].expand(u.shape)),
            torch.gather(ll, 1, src), accept)


def parallel_tempering(key, model, args, observed, *, betas=None,
                       num_replicas=8, num_chains=1, num_rounds=500,
                       moves_per_round=1, move="hmc", step_size=0.1,
                       num_leapfrog=8, selection=None,
                       record_all_replicas=False, device=None):
    """Run replica-exchange MCMC, on the card unless ``device`` names
    another; returns the cold (beta = 1) replica's samples.

    ``betas``: increasing inverse temperatures ending at 1 (default a
    geometric ladder from 0.05 over ``num_replicas`` rungs). Returns
    {"samples": {addr: (C, rounds, ...)} of the cold replica (all replicas,
    (C, rounds, K, ...), with ``record_all_replicas``), "unconstrained",
    "move_accept" and "swap_accept" ((C, rounds, K)), "betas"}.
    """
    device, args, observed = entry_inputs(device, args, observed,
                                          "parallel_tempering")
    if move not in ("hmc", "mala"):
        raise ValueError(f"parallel_tempering: unknown move {move!r}")
    k_tr, k_init, k_run = split(key, 3)
    init_trace, _ = model.generate(k_tr, args, observed, device=device)
    joint_and_lik, u0_flat, _, constrain = _tempered_parts(
        model, args, init_trace, observed, selection, device)
    dtype = u0_flat.dtype
    if betas is None:
        betas = np.geomspace(0.05, 1.0, num_replicas)
    betas = torch.as_tensor(betas, dtype=dtype, device=device)
    c, k, d = num_chains, betas.shape[0], u0_flat.shape[0]

    lanes_vg = torch.func.vmap(torch.func.grad_and_value(
        tempered(joint_and_lik, None)))
    beta_lanes = betas.repeat(c)

    def vag(U):
        g, lp = lanes_vg(U, beta_lanes)
        return lp, g

    loglik_v = torch.func.vmap(lambda ui: joint_and_lik(ui)[1])
    # replicas jittered around the generate trace's latents
    u = u0_flat.to(device)[None, None, :] + 0.5 * normal_lanes(
        split_keys(k_init, c, device), (k, d), dtype)
    chains = split_keys(k_run, c, device)
    parity = 0
    samples, move_acc, swap_acc = [], [], []
    for r in range(num_rounds):
        k_move, k_swap = split_lanes(fold_in_lanes(chains, (1 << 32) + r),
                                     2).unbind(-1)
        rungs = fold_in_lanes(k_move[:, None], (1 << 32) + torch.arange(
            k, dtype=torch.int64, device=device)).reshape(-1)
        flat = u.reshape(c * k, d)
        acc = torch.zeros(c * k, dtype=torch.bool, device=device)
        for m in range(moves_per_round):
            # the reference moves each replica as a batch of one:
            # split(fold_in(k_rung, m), 1)[0] keys it
            keys = fold_in_lanes(fold_in_lanes(rungs, m), 1 << 32)
            if move == "hmc":
                flat, acc = _tempered_hmc_move(keys, flat, vag, step_size,
                                               num_leapfrog)
            else:
                flat, acc = _tempered_mala_move(keys, flat, vag, step_size)
        u = flat.reshape(c, k, d)
        ll = loglik_v(flat).reshape(c, k)
        u, ll, swap = _swap_round(k_swap, u, ll, betas, parity)
        samples.append(u if record_all_replicas else u[:, -1])
        move_acc.append(acc.reshape(c, k))
        swap_acc.append(swap)
        parity = 1 - parity
    us = torch.stack(samples, dim=1)
    return {"samples": constrain(us), "unconstrained": us,
            "move_accept": torch.stack(move_acc, dim=1),
            "swap_accept": torch.stack(swap_acc, dim=1), "betas": betas}
