"""The batched-tier particle filter over a mesh of shards (counterpart of
modppl_tpu/parallel/sharded_smc.py).

Per step: a systematic resample from a layout-invariant blocked CDF, then
ONE batched generate over the shard's particles, bootstrap or guided, and
optionally rejuvenation moves (``inference/vsmc.guided_step``). The CDF,
its block totals and the slot positions S come from kernels 1 and 2
(ops/grid_positions.py) on every shard's own rows.

One device (``mesh`` None, or a mesh of one shard): the ancestors and the
state copy come from kernel 3 (ops/fused_resample.py). Over dp shards, one
process a shard (parallel/mesh.py), the shards exchange only what moves,
as the reference's ``shard_map`` does (parallel/collectives.py):

- the weights' max by ``pmax``, the block totals by an all_gather in shard
  order, so every shard adds the same blocks in the same order;
- S by an all_gather (O(N) int32, never the state), the parents of all N
  slots from it by kernel 4 (``grid_rank``, bitwise the reference's
  scatter and cumsum), and the shard's slice of them;
- the state rows: systematic parents are sorted, so shard k's parents lie
  near its own block. When every shard's parents fall within ``halo`` rows
  of its block (one host read of a replicated flag a step), each shard
  takes a halo from each neighbour (two ``ppermute``s of O(halo C) rows);
  otherwise the blocks rotate once round the ring (O(n_local C) a round),
  and no shard ever holds the (N, C) state.

Every particle draws from its own lane stream keyed by its global index
(modeling/autobatch.py), so dp = 1 and dp = k give the same bits: S, the
parents, the states, the weights, ESS and the log-ML. On CPU tensors the
kernels run their plain versions, which compute the reference's XLA path;
the tests hold them bitwise to it.

Nothing here reads a device value on the host but the halo flag: ESS, the
resample flag, the moves' accept decisions and the log marginal likelihood
stay on the device until the caller reads them.
"""

import contextlib
import math

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.core.keys import fold_in, generator, split
from modppl_tpu_torch.inference.adaptation import _tree_sum
from modppl_tpu_torch.inference import vsmc
from modppl_tpu_torch.modeling.handlers import entry_device, to_device
from modppl_tpu_torch.ops.fused_resample import parents_from_s
from modppl_tpu_torch.ops.grid_positions import (
    doubling_cumsum,
    positions_cummax,
    stats_cumsum,
)
from modppl_tpu_torch.ops.resample import grid_rank
from modppl_tpu_torch.parallel.collectives import (
    all_gather,
    axis_index,
    pmax,
    ppermute,
)
from modppl_tpu_torch.parallel.resample import gather_from_s
from modppl_tpu_torch.utils.profiling import annotate

_B0 = 1024        # max CDF block width
_MIN_BLOCKS = 64  # min block count
_INT32_MIN = -(2 ** 31)

_doubling_cumsum = doubling_cumsum
_parents_from_s = parents_from_s

#: the multi-shard exchanges taken since the last reset, by path
exchanges = {"halo": 0, "ring": 0}


def _cdf_block(num_particles):
    """Block width of the blocked CDF, a function of N only."""
    n_blocks = max(num_particles // _B0, _MIN_BLOCKS)
    if num_particles % n_blocks:
        raise ValueError(
            f"sharded filter: num_particles {num_particles} must be a "
            f"multiple of {n_blocks} (power-of-two sizes)")
    return num_particles // n_blocks


def _det_sum(x, num_total, axis_name=None):
    """Fixed-order sum over the (possibly sharded) particle axis: per-block
    totals from the Hillis-Steele scan's last column, all-gathered in shard
    order over ``axis_name``, then the adjacent-pairing tree over them."""
    rows = x.reshape(-1, _cdf_block(num_total))
    totals = _doubling_cumsum(rows)[:, -1]
    if axis_name is not None:
        totals = all_gather(totals, axis_name)
    return _tree_sum(totals)


def det_logsumexp(lw, num_total, axis_name=None):
    """logsumexp over the (possibly sharded) particle axis with the exact
    max (``pmax``) and the fixed-order blocked sum: bitwise the same at any
    shard count."""
    m = torch.max(lw)
    if axis_name is not None:
        m = pmax(m, axis_name)
    return m + torch.log(_det_sum(torch.exp(lw - m), num_total, axis_name))


def systematic_uniform(key, like):
    """The resample step's single uniform, drawn on ``like``'s device from
    the stream of ``fold_in(key, 0)`` (the reference's ``k_pos``)."""
    g = generator(fold_in(key, 0), like.device)
    return torch.rand((), generator=g, device=like.device, dtype=like.dtype)


def _exclusive_cummax(x):
    prev = torch.cummax(x, dim=0).values
    return torch.cat([torch.full((1,), _INT32_MIN, dtype=torch.int32,
                                 device=x.device), prev[:-1]])


def _det_grid_positions(u, lw, num_particles, axis_name=None):
    """Sorted systematic slot positions S = cummax(ceil(N*cdf - u)) from the
    blocked CDF, for the shard's particles ``lw`` (all N without
    ``axis_name``). The block totals cross shards by an all_gather in shard
    order, so the CDF's offsets and the total are the same adds at any
    shard count; the integer cummax crosses shards by the exclusive running
    max of the shards' last S. Returns (s, log_total, ess), all on lw's
    device."""
    n = num_particles
    n_local = lw.shape[0]
    block = _cdf_block(n)
    if n_local % block:
        raise ValueError(f"sharded filter: {n_local} particles a shard is "
                         f"not a multiple of the CDF block {block}")
    m = torch.max(lw)
    if axis_name is not None:
        m = pmax(m, axis_name)
    cum, totals, sq_totals = stats_cumsum(lw.reshape(-1, block), m)
    if axis_name is not None:
        totals = all_gather(totals, axis_name)
        sq_totals = all_gather(sq_totals, axis_name)
    offs_incl = _doubling_cumsum(totals[None, :])[0]
    offs_excl = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
    if axis_name is not None:
        nb = n_local // block
        idx0 = axis_index(axis_name) * nb
        offs_excl = offs_excl[idx0:idx0 + nb].contiguous()
    total = offs_incl[-1]
    log_total = m + torch.log(total)
    ess = (total * total) / _tree_sum(sq_totals)
    s_rows, mx = positions_cummax(cum, offs_excl, total, u, n)
    # cross-block repair: exclusive running maxima of the block maxima, then
    # one elementwise max (the same integers as a global cummax)
    s = torch.maximum(s_rows, _exclusive_cummax(mx)[:, None]).reshape(n_local)
    if axis_name is not None:
        # and across shards: the exclusive running max of their last S
        prev = _exclusive_cummax(all_gather(s[-1:], axis_name))
        s = torch.maximum(s, prev[axis_index(axis_name)])
    return s, log_total, ess


def _halo_gather(state, parents, axis_name, n_shards, halo):
    """The fast exchange: a window of [left halo | own block | right halo]
    by two neighbour ``ppermute``s, then a local row gather. The caller
    has checked that every parent falls inside the window."""
    me = axis_index(axis_name)
    n_local = parents.shape[0]
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [((i + 1) % n_shards, i) for i in range(n_shards)]
    idx = torch.clamp(parents.long() - (me * n_local - halo), 0,
                      n_local + 2 * halo - 1)

    def one(leaf):
        left = ppermute(leaf[-halo:], axis_name, fwd)
        right = ppermute(leaf[:halo], axis_name, bwd)
        return torch.cat([left, leaf, right])[idx]

    return pytree.tree_map(one, state)


def _ring_gather(state, parents, axis_name, n_shards):
    """The fallback exchange: the blocks rotate round the ring; each round
    the rows whose parent lives in the resident block are taken from it.
    O(n_local C) a shard at any time."""
    me = axis_index(axis_name)
    n_local = parents.shape[0]
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    parents = parents.long()
    src_shard = parents // n_local
    buf = state
    out = pytree.tree_map(torch.zeros_like, state)
    for r in range(n_shards):
        src = (me - r) % n_shards
        sel = src_shard == src
        idx = torch.clamp(parents - src * n_local, 0, n_local - 1)
        out = pytree.tree_map(
            lambda o, b: torch.where(
                sel.reshape((-1,) + (1,) * (o.ndim - 1)), b[idx], o),
            out, buf)
        if r < n_shards - 1:
            buf = pytree.tree_map(
                lambda b: ppermute(b, axis_name, fwd), buf)
    return out


def _exchange(s, state, num_particles, axis_name, n_shards, halo):
    """The multi-shard resample of the shard's ``state`` from its S: the
    parents of every slot from the all-gathered S (kernel 4), this shard's
    slice of them, and its rows by the halo or the ring exchange. Returns
    (state, parents)."""
    n = num_particles
    n_local = s.shape[0]
    me = axis_index(axis_name)
    parents_all = grid_rank(all_gather(s, axis_name), n)
    parents = parents_all[me * n_local:(me + 1) * n_local]
    # the shards' parent ranges, replicated, decide whether the halo holds
    firsts = torch.arange(n_shards, device=s.device) * n_local
    lasts = firsts + (n_local - 1)
    fits = bool(torch.all((parents_all[firsts] >= firsts - halo)
                          & (parents_all[lasts] <= lasts + halo)))
    if fits:
        exchanges["halo"] += 1
        return _halo_gather(state, parents, axis_name, n_shards,
                            halo), parents
    exchanges["ring"] += 1
    return _ring_gather(state, parents, axis_name, n_shards), parents


def _shards(mesh, axis="dp"):
    """(shard count, this shard's index) along ``axis`` of ``mesh``."""
    from modppl_tpu_torch.parallel.mesh import Mesh

    if mesh is None:
        return 1, 0
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: expected a parallel.mesh.Mesh or None, got "
                        f"{type(mesh).__name__}")
    ax = mesh.axis(axis)
    return ax.size, ax.index


def make_resample_step(mesh, num_particles, ess_threshold, axis="dp",
                       halo=None):
    """The per-step (maybe-)resample block over the shards of ``mesh``'s
    ``axis`` (one device for None or one shard). Returns ``fn(key,
    lw_local, state_local, u=None) -> (state, lw, d_log_ml, parents, ess,
    resampled)`` on the shard's particles (``parents`` global indices);
    ``u`` replaces the uniform drawn from ``key``. ``halo`` (default the
    reference's: a quarter of a shard, at most N / 2dp rows, at least 1)
    bounds the fast exchange's window. Over several shards it must run
    inside the mesh (``with mesh:``).
    """
    n = num_particles
    n_shards, me = _shards(mesh, axis)
    if n % n_shards:
        raise ValueError(f"num_particles {n} does not divide over "
                         f"{axis}={n_shards}")
    n_local = n // n_shards
    if halo is None:
        halo = max(min(n_local // 4, n // (2 * n_shards)), 1)
    halo = int(min(halo, n_local))
    axis_name = axis if n_shards > 1 else None
    log_n = math.log(float(n))

    def step(key, lw, state, u=None):
        if u is None:
            u = systematic_uniform(key, lw)
        s, log_total, ess = _det_grid_positions(u, lw, n, axis_name)
        if axis_name is None:
            new_state, parents = gather_from_s(s, state)
        else:
            new_state, parents = _exchange(s, state, n, axis_name, n_shards,
                                           halo)
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
        slots = me * n_local + torch.arange(n_local, dtype=torch.int32,
                                            device=lw.device)
        return (new_state, torch.where(do, torch.zeros_like(lw), lw),
                torch.where(do, log_total - log_n,
                            torch.zeros_like(log_total)),
                torch.where(do, parents, slots), ess, do)

    return step


def _filter_parts(mesh, kernel, num_particles, ess_threshold, auto_batch,
                  proposal=None, proposal_params=None, rejuvenation=None,
                  halo=None):
    """The one-shot and checkpointed filters' shared construction: the
    wrapped kernel, the resample step, the fixed-order logsumexp and the
    per-step body. Returns ``(body, lse, wrapped_kernel, offset)``;
    ``offset`` is this shard's first particle.
    ``body(s, constraints_t, replay=None, record=None) -> (s, (parents,
    ess, resampled, acceptance))`` is one step over the shard's particles:
    the key split four ways (carry, resample, extend, rejuvenate), the
    resample, the extend and the moves. Every key a step draws with comes
    from ``s.key``, so a run chunked on the host over this body
    (inference/checkpointed.py) replays the one-shot filter bit for bit.
    ``replay`` is one entry of the filter's, ``record`` a list the step
    appends its entry to (one shard only). Over several shards it runs
    inside the mesh."""
    kernel, proposal = vsmc.wrap_kernel(kernel, proposal, rejuvenation,
                                        auto_batch, "sharded filter")
    n = num_particles
    _cdf_block(n)
    n_shards, me = _shards(mesh)
    resample_step = make_resample_step(mesh, n, ess_threshold, halo=halo)
    n_local = n // n_shards
    offset = me * n_local
    axis_name = "dp" if n_shards > 1 else None

    def lse(log_weights):
        return det_logsumexp(log_weights, n, axis_name)

    def body(s, constraints_t, replay=None, record=None):
        if n_shards > 1 and (replay is not None or record is not None):
            raise ValueError("sharded filter: replay and record take one "
                             "shard")
        key, k_res, k_gen, k_rej = split(s.key, 4)
        u, *entry = vsmc.replay_entry(replay)
        with annotate("modppl.resample"):
            if u is None:
                u = systematic_uniform(k_res, s.log_weights)
            state, lw, d_log_ml, parents, ess, do = resample_step(
                k_res, s.log_weights, s.state, u=u)
        resampled = vsmc.SMCState(key, state, lw, s.log_ml + d_log_ml, s.t)
        with annotate("modppl.extend"):
            trace, w, accepts, draws = vsmc.guided_step(
                resampled, kernel, k_gen, k_rej, constraints_t, n_local,
                proposal, proposal_params, rejuvenation, entry,
                record=record is not None, offset=offset)
        if record is not None:
            record.append((u, *draws))
        acceptance = None
        if accepts is not None:
            # the exact count of accepts over every shard, then the mean
            count = accepts.sum(dim=1)
            if axis_name is not None:
                count = all_gather(count[None], axis_name).sum(dim=0)
            acceptance = count.to(w.dtype) / n
        new = vsmc.SMCState(key, trace.retv, lw + w, resampled.log_ml,
                            s.t + 1)
        return new, (parents, ess, do, acceptance)

    return body, lse, kernel, offset


def entered(mesh):
    """``with entered(mesh):`` enters ``mesh``, or nothing for None."""
    return contextlib.nullcontext() if mesh is None else mesh


def filter_device(mesh, device, what):
    """The device a (sharded) filter runs on: this rank's shard device
    over a mesh (parallel/mesh.shard_device), else ``entry_device``'s."""
    if mesh is None:
        return entry_device(device, what)
    from modppl_tpu_torch.parallel.mesh import shard_device

    return shard_device(device)


@annotate("modppl.filter")
def sharded_batched_particle_filter(mesh, key, kernel, state0,
                                    init_constraints, step_constraints,
                                    num_particles, ess_threshold=1.0,
                                    auto_batch=False, halo=None,
                                    store_ancestry=True, proposal=None,
                                    proposal_params=None, rejuvenation=None,
                                    replay=None, record=None, device=None):
    """The batched-tier particle filter over the dp shards of ``mesh``
    (None: one device), on the card unless ``device`` names another
    (``device="cpu"``); ``state0``, the constraints and ``proposal_params``
    are moved there. Over a mesh each rank runs this with the same
    arguments and holds ``num_particles / dp`` particles, the particles
    ``[k n_local, (k + 1) n_local)`` at dp index k, on its shard device
    (``parallel/mesh.shard_device``).

    ``key`` is an integer PRNG key (core/keys.py); each step splits it four
    ways (carry, resample, extend, rejuvenate). ``step_constraints`` is a
    Trie whose values are stacked over the T-1 steps on their leading axis.
    Resampling is systematic; ``halo`` bounds the multi-shard fast
    exchange (``make_resample_step``). ``auto_batch``, ``proposal``,
    ``proposal_params`` and ``rejuvenation`` are as in
    ``inference/vsmc.batched_particle_filter``.

    ``replay`` (one shard only): a list of T entries that replaces the
    filter's own draws, ``(u, pool)`` a step (``u`` None for the init):
    ``u`` the resample uniform, ``pool`` the generate's draws by address;
    with a proposal or rejuvenation ``(u, pool, proposal_pool, moves)``,
    ``proposal_pool`` the proposal's draws and ``moves`` one ``(pool,
    accept_u)`` a move, the regenerate's draws and the accept uniforms.
    ``record``: a list the filter appends its own entries to, in the same
    form.

    Returns a dict: the shard's ``state`` and ``log_weights`` (the mesh's
    ``gather`` assembles them in shard order), its ``ancestors`` ((T-1,
    n_local) int32 global indices, or None without ``store_ancestry``);
    replicated on every shard: ``log_ml``, ``ess`` and ``resampled``
    ((T-1,) each) and ``acceptance`` ((T-1, num_moves), None without
    rejuvenation). All on the device; a dp-shard run is bitwise the
    one-device run's.
    """
    n = num_particles
    device = filter_device(mesh, device, "sharded_batched_particle_filter")
    body, lse, kernel, offset = _filter_parts(
        mesh, kernel, n, ess_threshold, auto_batch, proposal,
        proposal_params, rejuvenation, halo)
    n_local = n // _shards(mesh)[0]
    state0, init_constraints, step_constraints, proposal_params = to_device(
        (state0, init_constraints, step_constraints, proposal_params),
        device, trie_tensors=True)
    steps = vsmc.num_steps(step_constraints, replay)
    with entered(mesh):
        s, trace = vsmc.batched_smc_init(
            key, kernel, state0, init_constraints, n_local,
            pool=replay[0][1] if replay else None, offset=offset)
        if record is not None:
            record.append((None, vsmc.generated_draws(trace,
                                                      init_constraints)))
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

