"""The batched-tier particle filter, one device (counterpart of the dp=1
body of modppl_tpu/parallel/sharded_smc.py).

Per step: a systematic resample from a layout-invariant blocked CDF, then
ONE batched generate over all particles, bootstrap or guided, and
optionally rejuvenation moves (``inference/vsmc.guided_step``). The CDF,
its block totals and the slot positions S come from kernels 1 and 2
(ops/grid_positions.py), and the ancestors and the state copy from kernel 3
(ops/fused_resample.py). On CPU tensors the same code runs their plain
versions, which compute the reference's XLA path; the tests hold them
bitwise to it.

Nothing here reads a device value on the host: ESS, the resample flag,
the moves' accept decisions and the log marginal likelihood stay on the
device until the caller reads them. The multi-device layout (``mesh``) is
not ported yet and raises ``NotImplementedError``.
"""

import math

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import fold_in, generator, split
from modppl_tpu_torch.inference.adaptation import _tree_sum
from modppl_tpu_torch.inference.vsmc import (
    SMCState,
    batched_smc_init,
    generated_draws,
    guided_step,
    num_steps,
    replay_entry,
    wrap_kernel,
)
from modppl_tpu_torch.modeling.handlers import entry_device, to_device
from modppl_tpu_torch.ops.fused_resample import parents_from_s
from modppl_tpu_torch.ops.grid_positions import (
    doubling_cumsum,
    positions_cummax,
    stats_cumsum,
)
from modppl_tpu_torch.parallel.resample import gather_from_s

_B0 = 1024        # max CDF block width
_MIN_BLOCKS = 64  # min block count
_INT32_MIN = -(2 ** 31)

_doubling_cumsum = doubling_cumsum
_parents_from_s = parents_from_s


def _cdf_block(num_particles):
    """Block width of the blocked CDF, a function of N only."""
    n_blocks = max(num_particles // _B0, _MIN_BLOCKS)
    if num_particles % n_blocks:
        raise ValueError(
            f"sharded filter: num_particles {num_particles} must be a "
            f"multiple of {n_blocks} (power-of-two sizes)")
    return num_particles // n_blocks


def _det_sum(x, num_total):
    """Fixed-order sum: per-block totals from the Hillis-Steele scan's last
    column, then the adjacent-pairing tree over the block totals."""
    rows = x.reshape(-1, _cdf_block(num_total))
    return _tree_sum(_doubling_cumsum(rows)[:, -1])


def det_logsumexp(lw, num_total):
    """logsumexp with the exact max and the fixed-order blocked sum."""
    m = torch.max(lw)
    return m + torch.log(_det_sum(torch.exp(lw - m), num_total))


def systematic_uniform(key, like):
    """The resample step's single uniform, drawn on ``like``'s device from
    the stream of ``fold_in(key, 0)`` (the reference's ``k_pos``)."""
    g = generator(fold_in(key, 0), like.device)
    return torch.rand((), generator=g, device=like.device, dtype=like.dtype)


def _det_grid_positions(u, lw, num_particles):
    """Sorted systematic slot positions S = cummax(ceil(N*cdf - u)) from the
    blocked CDF. Returns (s, log_total, ess), all on lw's device."""
    n = num_particles
    block = _cdf_block(n)
    m = torch.max(lw)
    cum, totals, sq_totals = stats_cumsum(lw.reshape(-1, block), m)
    offs_incl = _doubling_cumsum(totals[None, :])[0]
    offs_excl = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
    total = offs_incl[-1]
    log_total = m + torch.log(total)
    ess = (total * total) / _tree_sum(sq_totals)
    s_rows, mx = positions_cummax(cum, offs_excl, total, u, n)
    # cross-block repair: exclusive running maxima of the block maxima, then
    # one elementwise max (the same integers as a global cummax)
    prev = torch.cummax(mx, dim=0).values
    prev = torch.cat([torch.full((1,), _INT32_MIN, dtype=torch.int32,
                                 device=mx.device), prev[:-1]])
    s = torch.maximum(s_rows, prev[:, None]).reshape(n)
    return s, log_total, ess


def make_resample_step(mesh, num_particles, ess_threshold):
    """The per-step (maybe-)resample block.

    Returns ``fn(key, lw, state, u=None) -> (state, lw, d_log_ml, parents,
    ess, resampled)``; ``u`` replaces the uniform drawn from ``key``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "modppl_tpu_torch: only mesh=None (one device) is ported")
    n = num_particles
    log_n = math.log(float(n))

    def step(key, lw, state, u=None):
        if u is None:
            u = systematic_uniform(key, lw)
        s, log_total, ess = _det_grid_positions(u, lw, n)
        new_state, parents = gather_from_s(s, state)
        if ess_threshold >= 1.0:
            # threshold 1.0 resamples every step; no select on a device flag
            do = torch.ones((), dtype=torch.bool, device=lw.device)
            return (new_state, torch.zeros_like(lw), log_total - log_n,
                    parents, ess, do)
        # the choice stays on the device: both arms are computed and one is
        # selected elementwise, where a Python `if` would sync every step
        do = ess < ess_threshold * n
        new_state = pytree.tree_map(lambda a, b: torch.where(do, a, b),
                                    new_state, state)
        slots = torch.arange(n, dtype=torch.int32, device=lw.device)
        return (new_state, torch.where(do, torch.zeros_like(lw), lw),
                torch.where(do, log_total - log_n, torch.zeros_like(log_total)),
                torch.where(do, parents, slots), ess, do)

    return step


def _filter_parts(mesh, kernel, num_particles, ess_threshold, auto_batch,
                  proposal=None, proposal_params=None, rejuvenation=None):
    """The one-shot and checkpointed filters' shared construction: the
    wrapped kernel, the resample step, the fixed-order logsumexp and the
    per-step body. Returns ``(body, lse, wrapped_kernel)``;
    ``body(s, constraints_t, replay=None, record=None) -> (s, (parents,
    ess, resampled, acceptance))`` is one step: the key split four ways
    (carry, resample, extend, rejuvenate), the resample, the extend and the
    moves. Every key a step draws with comes from ``s.key``, so a run
    chunked on the host over this body (inference/checkpointed.py) replays
    the one-shot filter bit for bit. ``replay`` is one entry of the
    filter's, ``record`` a list the step appends its entry to."""
    if mesh is not None:
        raise NotImplementedError(
            "modppl_tpu_torch: only mesh=None (one device) is ported")
    kernel, proposal = wrap_kernel(kernel, proposal, rejuvenation,
                                   auto_batch, "sharded filter")
    n = num_particles
    _cdf_block(n)
    resample_step = make_resample_step(None, n, ess_threshold)

    def lse(log_weights):
        return det_logsumexp(log_weights, n)

    def body(s, constraints_t, replay=None, record=None):
        key, k_res, k_gen, k_rej = split(s.key, 4)
        u, *entry = replay_entry(replay)
        if u is None:
            u = systematic_uniform(k_res, s.log_weights)
        state, lw, d_log_ml, parents, ess, do = resample_step(
            k_res, s.log_weights, s.state, u=u)
        resampled = SMCState(key, state, lw, s.log_ml + d_log_ml, s.t)
        trace, w, accepted, draws = guided_step(
            resampled, kernel, k_gen, k_rej, constraints_t, n, proposal,
            proposal_params, rejuvenation, entry, record=record is not None)
        if record is not None:
            record.append((u, *draws))
        new = SMCState(key, trace.retv, lw + w, resampled.log_ml, s.t + 1)
        return new, (parents, ess, do, accepted)

    return body, lse, kernel


def sharded_batched_particle_filter(mesh, key, kernel, state0,
                                    init_constraints, step_constraints,
                                    num_particles, ess_threshold=1.0,
                                    auto_batch=False, store_ancestry=True,
                                    proposal=None, proposal_params=None,
                                    rejuvenation=None, replay=None,
                                    record=None, device=None):
    """The batched-tier particle filter, on the card unless ``device`` names
    another (``device="cpu"``); ``state0``, the constraints and
    ``proposal_params`` are moved there.

    ``key`` is an integer PRNG key (core/keys.py); each step splits it four
    ways (carry, resample, extend, rejuvenate). ``step_constraints`` is a
    Trie whose values are stacked over the T-1 steps on their leading axis.
    Resampling is systematic. ``auto_batch``, ``proposal``,
    ``proposal_params`` and ``rejuvenation`` are as in
    ``inference/vsmc.batched_particle_filter``.

    ``replay``: a list of T entries that replaces the filter's own draws,
    ``(u, pool)`` a step (``u`` None for the init): ``u`` the resample
    uniform, ``pool`` the generate's draws by address; with a proposal or
    rejuvenation ``(u, pool, proposal_pool, moves)``, ``proposal_pool`` the
    proposal's draws and ``moves`` one ``(pool, accept_u)`` a move, the
    regenerate's draws and the accept uniforms. ``record``: a list the
    filter appends its own entries to, in the same form.

    Returns a dict: ``state``, ``log_weights``, ``log_ml``, ``ancestors``
    ((T-1, N) int32, or None without ``store_ancestry``), ``ess`` and
    ``resampled`` ((T-1,) each) and ``acceptance`` ((T-1, num_moves), None
    without rejuvenation), all on the device.
    """
    n = num_particles
    body, lse, kernel = _filter_parts(mesh, kernel, n, ess_threshold,
                                      auto_batch, proposal, proposal_params,
                                      rejuvenation)
    device = entry_device(device, "sharded_batched_particle_filter")
    state0, init_constraints, step_constraints, proposal_params = to_device(
        (state0, init_constraints, step_constraints, proposal_params),
        device, trie_tensors=True)
    steps = num_steps(step_constraints, replay)

    s, trace = batched_smc_init(key, kernel, state0, init_constraints, n,
                                pool=replay[0][1] if replay else None)
    if record is not None:
        record.append((None, generated_draws(trace, init_constraints)))
    ancestors, ess_t, resampled_t, acceptance = [], [], [], []
    for i in range(steps):
        s, (parents, ess, do, accepted) = body(
            s, step_constraints.map(lambda v: v[i]),
            replay[i + 1] if replay else None, record)
        if store_ancestry:
            ancestors.append(parents)
        ess_t.append(ess)
        resampled_t.append(do)
        acceptance.append(accepted)

    log_ml = s.log_ml + lse(s.log_weights) - math.log(float(n))
    return {"state": s.state, "log_weights": s.log_weights, "log_ml": log_ml,
            "ancestors": torch.stack(ancestors) if store_ancestry else None,
            "ess": torch.stack(ess_t), "resampled": torch.stack(resampled_t),
            "acceptance": (torch.stack(acceptance)
                           if rejuvenation is not None else None)}
