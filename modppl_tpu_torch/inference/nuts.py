"""No-U-Turn Sampler, batched over chains (counterpart of
modppl_tpu/inference/nuts.py).

The multinomial NUTS of the reference, with its iterative tree: inside a
depth-j subtree the 2^j leapfrog leaves are visited left to right with a
checkpoint stack of at most ``max_depth + 1`` states for the sub-U-turn
checks (an even leaf i is pushed at slot popcount(i); after an odd leaf i
with t trailing one-bits the slots [popcount(i-1) - t + 1, popcount(i-1)]
are checked).

The reference vmaps one chain's two nested ``while_loop``s. Here the whole
batch of chains runs as one masked batch: every chain that is still
building its tree takes the same depth j and the same leaf index i, so i,
popcount(i), trailing_ones(i) and the checkpoint slots are host integers; a
chain that has turned or diverged keeps its state through ``torch.where``
while the others go on. Each leaf is ONE ``torch.func.vmap(grad_and_value)``
call over every chain (``hmc._value_and_grad``). The transition reads once
per subtree, before it starts, whether any chain is still building, and
stops when none is; without that read (``_early_stop=False``, kept to show
it) every transition runs all 2^max_depth - 1 leaves with the same
results.

Chain i's randoms come from its own lane key (core/keys.py): the pooled
path keys chain i of an iteration ``fold_in(k, i)`` and the per-chain path
``split(k_run, C)[i]``, as the reference does, so chain i's draws do not
depend on the number of chains. Every transition takes its draws from its
lane keys: momenta, then per depth the direction, the leaves' uniforms
(``fold_in(k_sub, i)`` for leaf i, all of a subtree's at once) and the
subtree's take uniform; ``draws=`` replaces them (the tests inject the
reference's). The reference's running momentum sum, which no decision
reads, is not kept.
"""

import torch

from modppl_tpu_torch.core.keys import (
    fold_in,
    fold_in_lanes,
    lanes,
    normal_lanes,
    split,
    split_keys,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.inference.hmc import (
    MULTI_SHARD_TODO,
    _stack_samples,
    _value_and_grad,
    flat_target,
)
from modppl_tpu_torch.modeling.handlers import entry_inputs

_DIVERGENCE = 1000.0


def _popcount(x):
    """The number of set bits of a non-negative int below 2^31 (the
    reference's 32-bit SWAR count)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _trailing_ones(x):
    return _popcount(x & ~(x + 1))


def _is_turning(inv_mass, z_left, p_left, z_right, p_right, direction=1.0):
    """Hoffman-Gelman U-turn criterion with stored (time-oriented) momenta,
    per chain over the last axis. For a subtree built in ``direction``,
    (left, right) are (start, current) and dz is re-oriented by it."""
    dz = (z_right - z_left) * direction
    return (torch.sum(dz * (inv_mass * p_left), -1) < 0.0) | \
        (torch.sum(dz * (inv_mass * p_right), -1) < 0.0)


def _leapfrog_once(vag, z, p, g, eps, inv_mass, direction):
    """One leapfrog step of every chain; returns (z, p, logp(z), grad(z))."""
    e = eps * direction
    p = p + 0.5 * e * g
    z = z + e * inv_mass * p
    lp, g = vag(z)
    p = p + 0.5 * e * g
    return z, p, lp, g


def _transition_draws(key_lanes, dim, max_depth, dtype):
    """A transition's randoms from its (C,) lane keys, split as the
    reference splits one chain's key: ``(z, depths)``, z the (C, dim)
    momentum normals and ``depths`` a function of j giving depth j's
    (go_right (C,) bool, take uniforms (C,), leaf uniforms (C, 2^j)). A
    depth's draws are made when the tree reaches it."""
    k_mom, k_loop = split_lanes(key_lanes, 2).unbind(-1)
    z = normal_lanes(k_mom, (dim,), dtype)
    keys = []

    def depth(j):
        while len(keys) <= j:
            keys.append(split_lanes(k_loop if not keys else keys[-1][3], 4)
                        .unbind(-1))
        k_dir, k_sub, k_take, _ = keys[j]
        leaves = torch.arange(1 << j, dtype=torch.int64,
                              device=key_lanes.device)
        return (uniform_lanes(k_dir, (), dtype) < 0.5,
                uniform_lanes(k_take, (), dtype),
                uniform_lanes(fold_in_lanes(k_sub[:, None], leaves), (),
                              dtype))

    return z, depth


def _injected(draws):
    """``draws`` = (z, [(go_right, take_u, leaf_u) a depth]) as
    ``_transition_draws`` gives them."""
    z, per_depth = draws
    return z, lambda j: per_depth[j]


def _where(mask, a, b):
    """``a`` where the (C,) ``mask`` else ``b``, over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def nuts_transition(key, u, vag, eps, inv_mass, max_depth=10, draws=None,
                    start=None, _early_stop=True):
    """One NUTS transition of every chain on flat coordinates.

    ``key``: (C,) lane keys, one a chain; ``u`` (C, d); ``vag(U) -> (logp
    (C,), grad (C, d))`` (one batched value-and-grad call, the reference's
    ``logp_fn`` and ``grad_fn``); ``eps`` () or (C,); ``inv_mass`` (d,) or
    (C, d). ``draws`` replaces the randoms of ``key`` (see
    ``_transition_draws``); ``start`` = (logp, grad) at ``u`` saves the
    first call. Returns (u', logp(u'), stats): stats holds the per-chain
    ``accept_prob``, ``divergent``, ``tree_depth`` and ``num_leapfrog``,
    ``leaves`` (the value-and-grad calls of the tree, a host int) and
    ``carry`` ((logp, grad) at u', for the next transition's ``start``).
    """
    c, dim = u.shape
    dtype = u.dtype
    im = inv_mass if inv_mass.ndim == 2 else inv_mass[None, :]
    eps = torch.as_tensor(eps, dtype=dtype, device=u.device)
    eps = eps[:, None] if eps.ndim == 1 else eps
    z0, depth_draws = (_injected(draws) if draws is not None
                       else _transition_draws(key, dim, max_depth, dtype))
    lp0, g0 = start if start is not None else vag(u)
    p0 = z0 / torch.sqrt(im)
    h0 = -lp0 + 0.5 * torch.sum(im * p0 * p0, -1)

    zl, pl, gl = zr, pr, gr = u, p0, g0
    prop, prop_lp, prop_vlp, prop_g = u, lp0, lp0, g0
    lsw = torch.zeros_like(lp0)  # the initial point: logw = h0 - h0
    false = torch.zeros(c, dtype=torch.bool, device=u.device)
    turning, divergent = false, false
    sum_acc = torch.zeros_like(lp0)
    n_lf = torch.zeros(c, dtype=torch.int32, device=u.device)
    depth = torch.zeros(c, dtype=torch.int32, device=u.device)
    leaves = 0
    for j in range(max_depth):
        active = ~turning & ~divergent
        if _early_stop and not bool(active.any()):
            break
        right, take_u, leaf_u = depth_draws(j)
        direction = torch.where(right, 1.0, -1.0).to(dtype)[:, None]
        z = _where(right, zr, zl)
        p = _where(right, pr, pl)
        g = _where(right, gr, gl)

        # the subtree of 2^j leaves, every chain at leaf i together
        s_prop, s_plp = z, torch.full_like(lp0, -torch.inf)
        s_vlp, s_g = lp0, g0
        s_lsw = torch.full_like(lp0, -torch.inf)
        s_turn, s_div = false, false
        s_acc = torch.zeros_like(lp0)
        s_n = torch.zeros(c, dtype=torch.int32, device=u.device)
        ckz = u.new_zeros((c, max_depth + 1, dim))
        ckp = u.new_zeros((c, max_depth + 1, dim))
        for i in range(1 << j):
            live = active & ~s_turn & ~s_div
            z1, p1, vlp, g1 = _leapfrog_once(vag, z, p, g, eps, im, direction)
            leaves += 1
            kin = 0.5 * torch.sum(im * p1 * p1, -1)
            h = -vlp + kin
            logw = h0 - h
            div = ~torch.isfinite(logw) | (logw < -_DIVERGENCE)
            lsw_new = torch.logaddexp(s_lsw, logw)
            take = live & (torch.log(leaf_u[:, i]) < logw - lsw_new)
            s_prop = _where(take, z1, s_prop)
            s_plp = torch.where(take, -h + kin, s_plp)
            s_vlp = torch.where(take, vlp, s_vlp)
            s_g = _where(take, g1, s_g)
            # a NaN leaf (a log-density NaN far out) accepts 0: the
            # reference's min(1, exp(logw)) is NaN there, which makes the
            # transition's accept_prob NaN and, pooled, every chain's eps
            acc = torch.where(torch.isnan(logw), 0.0,
                              torch.clamp(torch.exp(logw), max=1.0))
            s_acc = torch.where(live, s_acc + acc, s_acc)
            if i % 2 == 0:
                slot = _popcount(i)
                ckz[:, slot] = _where(live, z1, ckz[:, slot])
                ckp[:, slot] = _where(live, p1, ckp[:, slot])
            else:
                hi = _popcount(max(i - 1, 0))
                lo = hi - _trailing_ones(i) + 1
                turn = _is_turning(im[:, None], ckz[:, lo:hi + 1],
                                   ckp[:, lo:hi + 1], z1[:, None],
                                   p1[:, None], direction[:, None]).any(-1)
                s_turn = s_turn | (live & turn)
            s_div = s_div | (live & div)
            s_lsw = torch.where(live, lsw_new, s_lsw)
            z, p, g = _where(live, z1, z), _where(live, p1, p), \
                _where(live, g1, g)
            s_n = s_n + live.to(torch.int32)

        # biased progressive sampling between the tree and the subtree
        ok = active & ~s_turn & ~s_div
        take = ok & (torch.log(take_u) < s_lsw - lsw)
        prop = _where(take, s_prop, prop)
        prop_lp = torch.where(take, s_plp, prop_lp)
        prop_vlp = torch.where(take, s_vlp, prop_vlp)
        prop_g = _where(take, s_g, prop_g)
        lsw = torch.where(ok, torch.logaddexp(lsw, s_lsw), lsw)
        to_left, to_right = active & ~right, active & right
        zl, pl, gl = _where(to_left, z, zl), _where(to_left, p, pl), \
            _where(to_left, g, gl)
        zr, pr, gr = _where(to_right, z, zr), _where(to_right, p, pr), \
            _where(to_right, g, gr)
        turning = turning | (active & (s_turn | _is_turning(im, zl, pl, zr,
                                                            pr)))
        divergent = divergent | (active & s_div)
        sum_acc = torch.where(active, sum_acc + s_acc, sum_acc)
        n_lf = n_lf + torch.where(active, s_n, 0)
        depth = depth + active.to(torch.int32)

    accept_prob = sum_acc / torch.clamp(n_lf.to(dtype), min=1.0)
    stats = {"accept_prob": accept_prob, "divergent": divergent,
             "tree_depth": depth, "num_leapfrog": n_lf, "leaves": leaves,
             "carry": (prop_vlp, prop_g)}
    return prop, prop_lp, stats


class _Chains:
    """``nuts_transition`` over one batch of chains, which carries each
    transition's (logp, grad) at its proposal into the next transition on
    the same positions (the proposal's value-and-grad is one of the
    tree's), and counts the tree's value-and-grad calls."""

    def __init__(self, vag, max_depth):
        self.vag = vag
        self.max_depth = max_depth
        self.last = None
        self.leaves = 0

    def __call__(self, keys, us, eps, inv_mass, draws=None):
        start = (self.last[1] if self.last is not None
                 and self.last[0] is us else None)
        u, lp, stats = nuts_transition(keys, us, self.vag, eps, inv_mass,
                                       self.max_depth, draws=draws,
                                       start=start)
        self.last = (u, stats.pop("carry"))
        self.leaves += stats["leaves"]
        return u, lp, stats


def _sample_stats(u, lp, stats):
    return (u, lp, stats["accept_prob"], stats["divergent"],
            stats["tree_depth"])


def _pooled_nuts_chains(key, logprob, u0s, num_warmup, num_samples, eps0,
                        max_depth, target_accept, axis_name=None,
                        draws=None, chains=None):
    """Every chain shares ONE pooled-adapted (eps, inv_mass), as the
    reference's ``_pooled_nuts_chains``: ``adaptation.run_warmup_pooled``
    with a batched transition, chain i of an iteration keyed ``fold_in(k,
    i)``. ``draws``, one entry a transition (the warmup's, then
    sampling's; see ``nuts_transition``), replaces the lane draws.
    Returns (us, logps, aprobs, divs, depths) as (chains, samples, ...)
    and the shared eps."""
    from modppl_tpu_torch.inference.adaptation import run_warmup_pooled

    if axis_name is not None:
        raise NotImplementedError(MULTI_SHARD_TODO)
    c, device = u0s.shape[0], u0s.device
    step = chains or _Chains(_value_and_grad(logprob), max_depth)
    it = iter(draws) if draws is not None else None

    def move(k, us, eps, inv_mass):
        u, lp, stats = step(lanes(k, c, device), us, eps, inv_mass,
                            next(it) if it is not None else None)
        return u, lp, stats

    def warm_transition(k, us, eps, inv_mass):
        u, _, stats = move(k, us, eps, inv_mass)
        return u, stats["accept_prob"]

    us, eps, inv_mass = run_warmup_pooled(
        fold_in(key, 0), u0s, warm_transition, num_warmup, eps0,
        target_accept, batched_transition=True)
    ys = []
    for k in split(fold_in(key, 2), num_samples):
        us, lp, stats = move(k, us, eps, inv_mass)
        ys.append(_sample_stats(us, lp, stats))
    return (*_stack_samples(ys), eps)


def _nuts_chain(chain_keys, logprob, u0s, num_warmup, num_samples, eps0,
                max_depth, target_accept, draws=None, chains=None):
    """Every chain adapts its own (eps, inv_mass): the reference's
    ``vmap(_nuts_chain)`` as one batch, through ``adaptation.run_warmup``.
    ``chain_keys`` (C,) are the chains' lane keys; chain i's warmup phase
    keys are ``fold_in(fold_in(chain_keys[i], 0), phase)``, split one a
    transition, its sampling keys ``split(fold_in(chain_keys[i], 2),
    num_samples)``. ``draws`` as for :func:`_pooled_nuts_chains`. Returns
    (us, logps, aprobs, divs, depths) as (chains, samples, ...) and eps
    (chains,)."""
    from modppl_tpu_torch.inference.adaptation import run_warmup

    step = chains or _Chains(_value_and_grad(logprob), max_depth)
    it = iter(draws) if draws is not None else None
    warm_keys = fold_in_lanes(chain_keys, 0)

    def phase_inputs(phase, _, length):
        keys = split_lanes(fold_in_lanes(warm_keys, phase), length)
        return keys.unbind(-1)

    def warm_transition(keys, us, eps, inv_mass):
        u, _, stats = step(keys, us, eps, inv_mass,
                           next(it) if it is not None else None)
        return u, stats["accept_prob"]

    us, eps, inv_mass = run_warmup(
        0, u0s, warm_transition, num_warmup, eps0, target_accept,
        phase_inputs=phase_inputs)
    ys = []
    for keys in split_lanes(fold_in_lanes(chain_keys, 2),
                            num_samples).unbind(-1):
        us, lp, stats = step(keys, us, eps, inv_mass,
                             next(it) if it is not None else None)
        ys.append(_sample_stats(us, lp, stats))
    return (*_stack_samples(ys), eps)


def nuts_runner(model, args, observed, *, num_samples=1000, num_warmup=500,
                num_chains=1, step_size=0.1, max_depth=8, target_accept=0.8,
                selection=None, init_trace=None, pooled_adaptation=None,
                axis_name=None, setup_key=0, device=None):
    """Build a reusable NUTS sampler: returns ``run(key) -> dict``.

    The NUTS counterpart of ``hmc.hmc_runner``: set-up (the initial trace
    and the unconstrained log-density) happens once, here, on ``device``
    (the card unless the caller passes ``device="cpu"``). ``run(k_run)``
    keys chain i ``split(k_run, C)[i]`` (its start point's jitter, and on
    the per-chain path its whole run); ``pooled_adaptation`` (default: more
    than one chain) shares one adapted (eps, inv_mass). ``axis_name``
    other than None raises (one device). ``run.chains`` is the last run's
    batch, whose ``leaves`` counts its value-and-grad calls.
    """
    if axis_name is not None:
        raise NotImplementedError(f"nuts_runner: {MULTI_SHARD_TODO}")
    device, args, observed = entry_inputs(device, args, observed,
                                          "nuts_runner")
    if init_trace is None:
        init_trace, _ = model.generate(setup_key, args, observed,
                                       device=device)
    target = flat_target(model, args, init_trace, observed, selection,
                         device=device)
    u0 = target.u0
    if pooled_adaptation is None:
        pooled_adaptation = num_chains > 1

    def run(k_run):
        chain_keys = split_keys(k_run, num_chains, device)
        u0s = u0[None, :] + 0.5 * normal_lanes(chain_keys, u0.shape,
                                               u0.dtype)
        run.chains = _Chains(_value_and_grad(target.logprob), max_depth)
        if pooled_adaptation:
            us, logps, aprobs, divs, depths, eps = _pooled_nuts_chains(
                fold_in(k_run, 0), target.logprob, u0s, num_warmup,
                num_samples, step_size, max_depth, target_accept,
                chains=run.chains)
        else:
            us, logps, aprobs, divs, depths, eps = _nuts_chain(
                chain_keys, target.logprob, u0s, num_warmup, num_samples,
                step_size, max_depth, target_accept, chains=run.chains)
        return {
            "samples": target.constrain(us),
            "logp": logps,
            "accept_prob": aprobs,
            "divergences": divs,
            "tree_depth": depths,
            "step_size": eps,
            "unconstrained": us,
        }

    run.chains = None
    return run


def nuts(key, model, args, observed, **config):
    """Adaptive NUTS over a model's unconstrained latents, chains batched.
    ``pooled_adaptation`` (default: on whenever num_chains > 1) shares one
    (eps, inv_mass). For repeated runs build the sampler once with
    :func:`nuts_runner`."""
    k_init, k_run = split(key)
    run = nuts_runner(model, args, observed, setup_key=k_init, **config)
    return run(k_run)
