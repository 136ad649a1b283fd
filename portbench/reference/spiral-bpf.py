"""Plain reference of the spiral bootstrap particle filter, and the numbers
that decide whether the program's filters in a window are correct.

The model (the configuration's file states it): a polar random walk
r_0 ~ U(0, 1), theta_0 ~ U(0, 2 pi); r_t = r_{t-1} + N(0, 0.1),
theta_t = theta_{t-1} + N(0.4, 0.2); each step observes
(r cos theta, r sin theta) + N(0, 0.001 I). The filter weights each
particle by its observation's density, resamples systematically before
every step after the first, and estimates the log marginal likelihood
(log-ML) as the sum over steps of log(mean weight).

The reference filters draw from their own ``torch.Generator``: a particle
filter's outputs are random, so the program's filters are judged against
the reference's as estimates of the same quantities (log-ML, the ESS
before each resample and the share of slots whose parent they share, at
the same N). The filter judged one by one is followed through its last
step: its draws are worked out again from its key by the keying the
program documents (``keys.py``), so its final states give back the states
the last resample gathered (``shared_parents``), and its final
log-weights are checked against their observation densities. Nothing here
imports the program.
"""

import math

import torch

from portbench.reference import keys


def observations(cfg, dtype=torch.float64, device="cpu"):
    """(T, 2) points on a circle: radius ``obs_radius``, one every
    1/``obs_per_turn`` turn."""
    t = torch.arange(cfg["num_steps"], dtype=torch.float64)
    ang = 2.0 * math.pi * t / cfg["obs_per_turn"]
    xy = cfg["obs_radius"] * torch.stack([torch.cos(ang), torch.sin(ang)], 1)
    return xy.to(dtype=dtype, device=device)


def obs_logpdf(pol, obs_t, var):
    """log N(obs_t; (r cos theta, r sin theta), var I) per particle."""
    r, th = pol[:, 0], pol[:, 1]
    dx = obs_t[0] - r * torch.cos(th)
    dy = obs_t[1] - r * torch.sin(th)
    return (-math.log(2.0 * math.pi) - math.log(var)
            - 0.5 * (dx * dx + dy * dy) / var)


class GeneratorDraws:
    """A reference filter's own draws, from one ``torch.Generator``."""

    def __init__(self, gen, n, dtype, device):
        self.gen, self.n, self.dtype, self.device = gen, n, dtype, device

    def uniform(self, t, address):
        return torch.rand(self.n, generator=self.gen, dtype=self.dtype,
                          device=self.device)

    def position(self, t):
        return torch.rand(1, generator=self.gen, dtype=self.dtype,
                          device=self.device)

    def normal(self, t, address):
        return torch.randn(self.n, generator=self.gen, dtype=self.dtype,
                           device=self.device)


def extend_keys(job_key, steps):
    """[(the extend's key, the resample's key)] of each step of a filter
    keyed ``job_key``: the init splits the key in two (extend, carry), and
    each later step splits the carry four ways (carry, resample, extend,
    rejuvenate). The init has no resample key."""
    k_gen, carry = keys.split(job_key)
    out = [(k_gen, None)]
    for _ in range(steps - 1):
        carry, k_res, k_gen, _ = keys.split(carry, 4)
        out.append((k_gen, k_res))
    return out


def site_uniforms(key, address, n, device):
    """(n,) float32 uniforms of the site ``address`` drawn with the extend
    key ``key``: particle i's is word 0 of the lane stream
    ``fold_in(fold_in(key, fnv1a31(address)), i)``."""
    lanes = keys.lane_keys(keys.fold_in(key, keys.fnv1a31(address)), n)
    u = keys.lane_uniforms(lanes, 1)[:, 0]
    return torch.from_numpy(u).to(device=device, dtype=torch.float32)


class KeyedDraws:
    """The draws of a filter keyed ``job_key``, as the program documents
    its keying: each site's lane streams, normals as the inverse normal
    CDF of float32 uniforms, and each resample's uniform from a generator
    seeded with ``fold_in(resample key, 0)``."""

    def __init__(self, job_key, steps, n, dtype, device):
        self.keys = extend_keys(job_key, steps)
        self.n, self.dtype, self.device = n, dtype, device

    def uniform(self, t, address):
        return site_uniforms(self.keys[t][0], address, self.n,
                             self.device).to(self.dtype)

    def position(self, t):
        g = keys.generator(keys.fold_in(self.keys[t][1], 0), self.device)
        u = torch.rand((), generator=g, dtype=torch.float32,
                       device=self.device)
        return u.reshape(1).to(self.dtype)

    def normal(self, t, address):
        u = site_uniforms(self.keys[t][0], address, self.n, self.device)
        return torch.special.ndtri(u).to(self.dtype)


def last_draws(cfg, job_key, n, device):
    """(n, 2) float32: the last step's (dr, dtheta) of every particle of
    the filter keyed ``job_key``, finished in float32 as the model's
    normals are (z sd + mean)."""
    k = extend_keys(job_key, cfg["num_steps"])[-1][0]
    z_r, z_th = (torch.special.ndtri(site_uniforms(k, a, n, device))
                 for a in ("dr", "dtheta"))
    return torch.stack([z_r * cfg["dr_sd"] + 0.0,
                        z_th * cfg["dtheta_sd"] + cfg["dtheta_mean"]], 1)


def run_filter(cfg, n, draws, dtype=torch.float64, device="cpu"):
    """One filter of ``n`` particles in ``dtype`` over ``draws``. Returns
    (log_ml, ess (T-1,)) as float64, the last resample's share of slots
    that share a parent (float), and the final (state (n, 2),
    log_weights (n,))."""
    obs = observations(cfg, dtype, device)
    var = cfg["obs_var"]
    r0 = cfg["r0_low"] + (cfg["r0_high"] - cfg["r0_low"]) * draws.uniform(
        0, "r")
    pol = torch.stack([r0, cfg["theta0_high_over_pi"] * math.pi
                       * draws.uniform(0, "theta")], dim=1)
    lw = obs_logpdf(pol, obs[0], var)
    log_ml = torch.zeros((), dtype=torch.float64, device=device)
    ess, shared = [], 0.0
    slots = torch.arange(n, dtype=dtype, device=device)
    for t in range(1, cfg["num_steps"]):
        m = lw.max()
        w = torch.exp(lw - m)
        total = w.sum()
        log_ml = log_ml + (m + torch.log(total) - math.log(n)).double()
        ess.append((total * total / (w * w).sum()).double())
        cdf = torch.cumsum(w, 0) / total
        pos = (draws.position(t) + slots) / n
        parents = torch.clamp(torch.searchsorted(cdf, pos), max=n - 1)
        shared = float((parents[1:] == parents[:-1]).sum()) / n
        pol = pol[parents] + torch.stack(
            [cfg["dr_sd"] * draws.normal(t, "dr"),
             cfg["dtheta_mean"] + cfg["dtheta_sd"] * draws.normal(t, "dtheta")],
            dim=1)
        lw = obs_logpdf(pol, obs[t], var)
    m = lw.max()
    log_ml = log_ml + (m + torch.log(torch.exp(lw - m).sum())
                       - math.log(n)).double()
    return log_ml, torch.stack(ess), shared, pol, lw


def reference_runs(cfg, n, seed, count, dtype=torch.float64, device="cpu"):
    """``count`` reference filters from generators seeded from ``seed``:
    (log_ml (count,), ess (count, T-1), shared (count,)), float64."""
    lml, ess, shared = [], [], []
    for i in range(count):
        g = torch.Generator(device=device)
        g.manual_seed((seed * 1_000_003 + 7919 * i) % (1 << 63))
        a, b, c, _, _ = run_filter(cfg, n, GeneratorDraws(g, n, dtype, device),
                                   dtype, device)
        lml.append(a)
        ess.append(b)
        shared.append(c)
    return (torch.stack(lml), torch.stack(ess),
            torch.tensor(shared, dtype=torch.float64))


def _z(prog, ref):
    """|mean difference| over its standard error, with the pooled spread of
    the two sets of filters (axis 0); the largest over any further axis."""
    n_p, n_r = prog.shape[0], ref.shape[0]
    gap = (prog.mean(0) - ref.mean(0)).abs()
    var = (((n_p - 1) * prog.var(0, unbiased=True) if n_p > 1 else 0.0)
           + ((n_r - 1) * ref.var(0, unbiased=True) if n_r > 1 else 0.0))
    var = var / max(n_p + n_r - 2, 1)
    se = torch.sqrt(var * (1.0 / n_p + 1.0 / n_r))
    z = torch.where(se > 0, gap / torch.where(se > 0, se, 1.0),
                    torch.where(gap > 0, math.inf, 0.0))
    return float(z.max())


def weight_gap(cfg, state, log_weights):
    """The largest gap of a particle's final log-weight from its last
    observation's log-density at its final state, over 1 + |that density|
    (float64)."""
    obs = observations(cfg, torch.float64, state.device)
    want = obs_logpdf(state.double(), obs[-1], cfg["obs_var"])
    gap = (log_weights.double() - want).abs() / (1.0 + want.abs())
    gap = torch.where(torch.isnan(gap), math.inf, gap)
    return float(gap.max())


#: two slots hold one parent where their recovered parents agree to this
#: share of each coordinate's size (at least 1): 8 float32 ulps
SAME_PARENT = 2.0 ** -20


def shared_parents(cfg, job_key, state):
    """The share of slots whose parent is the next slot's, read from the
    final state of the filter keyed ``job_key``: the last step's draws are
    worked out again from the key and taken off each particle's final
    state, which leaves the state kernel 3 gathered for its slot. Slots of
    one parent sit side by side (systematic resampling keeps the parents
    in order) and agree to round-off; a slot whose draw is not its own
    lane's agrees with no neighbour."""
    n = state.shape[0]
    d = last_draws(cfg, job_key, n, state.device)
    g = state.double() - d.double()
    tol = SAME_PARENT * torch.clamp(state.double().abs(), min=1.0)
    same = ((g[1:] - g[:-1]).abs() <= torch.maximum(tol[1:], tol[:-1]))
    return float(same.all(1).sum()) / n


def compare(cfg, prog_log_ml, prog_ess, kept, ref):
    """The numbers compared: ``logml_z`` and ``ess_z`` (the program's
    window of filters against the reference's ``ref`` = (log_ml, ess,
    shared), as z-scores of the mean difference); over the filters in
    ``kept``, each (job key, state, log_weights) of a filter of the
    window, ``weight_gap`` and ``sibling_gap``: the relative gap of the
    share of slots that share a parent in the last resample
    (``shared_parents``) from the reference filters' mean share."""
    ref_lml, ref_ess, ref_shared = ref
    out = {"logml_z": _z(prog_log_ml.double(), ref_lml),
           "ess_z": _z(prog_ess.double(), ref_ess)}
    out["weight_gap"] = max(weight_gap(cfg, s, lw) for _, s, lw in kept)
    want = float(ref_shared.mean())
    out["sibling_gap"] = max(
        abs(shared_parents(cfg, k, s) - want) / want for k, s, _ in kept)
    return out


def numbers(cfg, job, seed, reference_units, window, device):
    """The numbers compared for a window of filters of the job's sizes:
    ``window`` = (log_ml (k,), ess (k, T-1), kept)."""
    cfg = {**cfg, "num_steps": job["steps"]}
    ref = reference_runs(cfg, job["particles"], seed, reference_units,
                         device=device)
    return compare(cfg, *window, ref)


def control_numbers(cfg, spec, job, seed, device, units=24):
    """The control's numbers: the reference in the program's place, in
    bfloat16, the nearest precision below the float32 the configuration
    states, as a window of ``units`` filters of the job's sizes. The
    first, the one judged one by one, is keyed by the job's key as the
    program's is; the others draw from generators."""
    cfg = {**cfg, "num_steps": job["steps"]}
    n, lml, ess, kept = job["particles"], [], [], []
    for i in range(units):
        if i == 0:
            draws = KeyedDraws(job["key"], job["steps"], n, torch.bfloat16,
                               device)
        else:
            g = torch.Generator(device=device)
            g.manual_seed((seed * 999_983 + 104_729 * i + 1) % (1 << 63))
            draws = GeneratorDraws(g, n, torch.bfloat16, device)
        a, b, _, pol, lw = run_filter(cfg, n, draws, torch.bfloat16, device)
        lml.append(a)
        ess.append(b)
        if i == 0:
            kept.append((job["key"], pol, lw))
    return numbers(cfg, job, seed, spec["reference_units"],
                   (torch.stack(lml), torch.stack(ess), kept), device)
