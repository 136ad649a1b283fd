"""Plain reference of pooled-adaptation HMC on the ill-conditioned Gaussian,
and the numbers that decide whether the program's run is correct.

The target (the configuration's file states it): x ~ N(0, Sigma) in d
dimensions, Sigma = Q diag(lambda) Q^T with lambda log-spaced over
[1/cond, 1] and Q the orthogonal factor of a QR of standard normals from
``numpy.random.default_rng(cov_seed)``, symmetrised and stored in float32.
A float32 evaluation of its log-density factors Sigma in float32
(``torch.linalg.cholesky``), so the precision Lambda is the inverse of that
factor's product, worked out here in float64.

A run: start points u0 + 0.5 z a chain (z from the chain's lane stream of
the run key), a warmup of ``num_warmup`` transitions with Stan's windowed
schedule (Nesterov dual averaging of the step size on the pooled mean
accept probability; in each slow window the pooled variance, shrunk toward
1e-3 by n / (n + 5), becomes the diagonal inverse mass), then
``num_samples`` transitions at the adapted step size and mass; every
transition is ``num_leapfrog`` leapfrog steps at eps times a jitter in
[0.5, 1.5) and a Metropolis accept. Every draw comes from the seed by the
keying of ``keys.py``, so the reference follows the program's run draw for
draw, and its step size, inverse mass, positions and accept probabilities
are compared with the program's. Nothing here imports the program.
"""

import math

import numpy as np
import torch

from portbench.reference import keys


def covariance(cfg):
    """Sigma as numpy float32 (d, d)."""
    d, cond = cfg["dim"], cfg["condition_number"]
    rng = np.random.default_rng(cfg["cov_seed"])
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.logspace(-np.log10(cond), 0.0, d)
    cov = (q * lam) @ q.T
    return np.asarray(0.5 * (cov + cov.T), np.float32)


def factor(cfg, device):
    """Sigma's float32 Cholesky factor on ``device``."""
    return torch.linalg.cholesky(torch.from_numpy(covariance(cfg)).to(device))


def precision(chol):
    """Lambda = (L L^T)^-1 in float64."""
    L = chol.double()
    eye = torch.eye(L.shape[0], dtype=torch.float64, device=L.device)
    inv = torch.linalg.solve_triangular(L, eye, upper=False)
    return inv.T @ inv


def initial_point(cfg, chol):
    """The initial trace's x: L z, z the standard normals of the site "x"
    drawn from ``fold_in(setup_key, fnv1a31("x"))``."""
    key = keys.fold_in(cfg["setup_key"], keys.fnv1a31("x"))
    z = torch.randn(cfg["dim"], generator=keys.generator(key, chol.device),
                    dtype=torch.float32, device=chol.device)
    return chol.double() @ z.double()


def phase_draws(key, num, n, d, device):
    """One phase's momenta z (num, n, d), jitters (num, n) in [0.5, 1.5)
    and accept uniforms (num, n), float32, from ``split(key, 3)``."""
    k_mom, k_jit, k_acc = keys.split(key, 3)
    z = torch.randn((num, n, d), generator=keys.generator(k_mom, device),
                    dtype=torch.float32, device=device)
    jit = torch.rand((num, n), generator=keys.generator(k_jit, device),
                     dtype=torch.float32, device=device) + 0.5
    u01 = torch.rand((num, n), generator=keys.generator(k_acc, device),
                     dtype=torch.float32, device=device)
    return z, jit, u01


def slow_windows(num_warmup, base=25):
    """Stan's doubling mass windows as (start, end) iterations: 15% of the
    warmup (at least 10) before them, 10% (at least 10) after."""
    if num_warmup < 20:
        return []
    fast1 = max(num_warmup * 15 // 100, 10)
    fast2 = max(num_warmup * 10 // 100, 10)
    remaining, w, start, out = num_warmup - fast1 - fast2, base, fast1, []
    while remaining > 0:
        size = remaining if remaining < 2 * w or remaining < base else w
        out.append((start, start + size))
        start += size
        remaining -= size
        w *= 2
    return out


def transition(u0, p0, eps, u01, lam, im, steps):
    """One HMC transition of every chain (rows). Returns (u, aprob)."""
    e = eps[:, None]
    g0 = -(u0 @ lam)
    h0 = -0.5 * u0 * g0 + 0.5 * im * p0 * p0
    u, p, g = u0, p0, g0
    for _ in range(steps):
        p = p + 0.5 * e * g
        u = u + e * im * p
        g = -(u @ lam)
        p = p + 0.5 * e * g
    dh = h0 - (-0.5 * u * g + 0.5 * im * p * p)
    fin = torch.isfinite(dh)
    dh_sum = torch.where(fin, dh, 0.0).sum(1)
    div = ~torch.isfinite(dh_sum) | (dh_sum < -1000.0) | ~fin.all(1)
    aprob = torch.where(div, 0.0,
                        torch.exp(torch.clamp(dh_sum, max=0.0)).clamp(max=1.0))
    acc = u01 < aprob
    return torch.where(acc[:, None], u, u0), aprob


def run(cfg, run_key, lam, u0, dtype=torch.float64):
    """One run keyed ``run_key``. Returns {"step_size", "inv_mass",
    "positions" (chains, samples, d), "accept_prob" (chains, samples)}."""
    dev = lam.device
    n, d = cfg["num_chains"], cfg["dim"]
    lam = lam.to(dtype)
    z0 = keys.lane_normals(keys.split_lane_keys(run_key, n), d, dev)
    u = (u0[None, :] + 0.5 * z0).to(dtype)
    key = keys.fold_in(run_key, 0)
    num, steps, target = cfg["num_warmup"], cfg["num_leapfrog"], \
        cfg["target_accept"]
    z, jit, u01 = phase_draws(keys.fold_in(key, 0), num, n, d, dev)
    eps0 = cfg["step_size"]
    log_eps = leb = math.log(eps0)
    mu, hbar, t_da, nw = math.log(10.0 * eps0), 0.0, 0.0, 0.0
    mean = m2 = torch.zeros(d, dtype=torch.float64, device=dev)
    im = torch.ones(d, dtype=dtype, device=dev)
    windows = slow_windows(num)
    ends = {e for _, e in windows}
    for t in range(num):
        if t in ends:
            shrink = nw / (nw + 5.0)
            var = shrink * m2 / max(nw - 1.0, 1.0) + (1.0 - shrink) * 1e-3
            im = torch.clamp(var, 1e-8, 1e8).to(dtype)
            log_eps, mu = leb, math.log(10.0) + leb
            hbar = t_da = nw = 0.0
            mean = m2 = torch.zeros(d, dtype=torch.float64, device=dev)
        p = z[t].to(dtype) / torch.sqrt(im)
        eps = math.exp(log_eps) * jit[t].to(dtype)
        u, aprob = transition(u, p, eps, u01[t].to(dtype), lam, im, steps)
        t_da += 1.0
        eta_h = 1.0 / (t_da + 10.0)
        hbar = (1.0 - eta_h) * hbar + eta_h * (target
                                               - float(aprob.double().mean()))
        log_eps = mu - math.sqrt(t_da) * 20.0 * hbar
        eta = t_da ** -0.75
        leb = eta * log_eps + (1.0 - eta) * leb
        if any(s <= t < e for s, e in windows):
            ud = u.double()
            b_mean = ud.mean(0)
            b_m2 = ((ud - b_mean) ** 2).sum(0)
            n_new = nw + n
            delta = b_mean - mean
            mean = mean + delta * n / n_new
            m2 = m2 + b_m2 + delta * delta * nw * n / n_new
            nw = n_new
    eps = math.exp(leb)
    z, jit, u01 = phase_draws(keys.fold_in(key, 2), cfg["num_samples"], n,
                              d, dev)
    us, aps = [], []
    for t in range(cfg["num_samples"]):
        p = z[t].to(dtype) / torch.sqrt(im)
        u, aprob = transition(u, p, eps * jit[t].to(dtype), u01[t].to(dtype),
                              lam, im, steps)
        us.append(u)
        aps.append(aprob)
    return {"step_size": eps, "inv_mass": im.double(),
            "positions": torch.stack(us, 1), "accept_prob": torch.stack(aps, 1)}


def follow(cfg, run_key, lam, got, block=16):
    """The reference's sampling transition t from the program's own
    position at t - 1, for t = 1 .. num_samples - 1, at the program's step
    size and inverse mass, on the run's draws. Returns the largest gap of
    an accept probability from the program's, and the share of transitions
    whose position leaves the program's by more than 1e-3 (1 + |x|)."""
    dev, n, d = lam.device, cfg["num_chains"], cfg["dim"]
    key = keys.fold_in(keys.fold_in(run_key, 0), 2)
    z, jit, u01 = phase_draws(key, cfg["num_samples"], n, d, dev)
    im = got["inv_mass"].to(dev, torch.float64)
    eps = float(got["step_size"])
    pos = got["positions"].to(dev)
    aprob = got["accept_prob"].to(dev)
    worst, apart, count = 0.0, 0, 0
    for t0 in range(1, cfg["num_samples"], block):
        ts = list(range(t0, min(t0 + block, cfg["num_samples"])))
        u_prev = pos[:, [t - 1 for t in ts]].double().transpose(0, 1)
        rows = len(ts) * n
        p = (z[ts].double() / torch.sqrt(im)).reshape(rows, d)
        u, a = transition(u_prev.reshape(rows, d), p,
                          eps * jit[ts].double().reshape(rows),
                          u01[ts].double().reshape(rows), lam, im,
                          cfg["num_leapfrog"])
        got_u = pos[:, ts].double().transpose(0, 1).reshape(rows, d)
        got_a = aprob[:, ts].double().transpose(0, 1).reshape(rows)
        gap_a = (got_a - a).abs()
        worst = max(worst, float(torch.where(torch.isnan(gap_a), math.inf,
                                             gap_a).max()))
        off = ((got_u - u).abs() / (1.0 + u.abs())).amax(1)
        apart += int(((off > 1e-3) | torch.isnan(off)).sum())
        count += rows
    return worst, apart / count


def compare(cfg, run_key, lam, got, want):
    """The numbers compared, for the program's run ``got`` ({"step_size",
    "inv_mass", "positions" (chains, samples, d), "accept_prob" (chains,
    samples)}) keyed ``run_key``, against the reference's run ``want`` on
    the same draws: the warmup's step size and inverse mass as relative
    gaps (the largest over the coordinates), and the sampling phase
    followed transition by transition (``follow``)."""
    eps_gap = abs(float(got["step_size"]) / want["step_size"] - 1.0)
    im_gap = float((got["inv_mass"].to(want["inv_mass"].device,
                                       torch.float64)
                    / want["inv_mass"] - 1.0).abs().max())
    aprob_gap, moves_apart = follow(cfg, run_key, lam, got)
    out = {"step_size_gap": eps_gap, "inv_mass_gap": im_gap,
           "aprob_gap": aprob_gap, "moves_apart": moves_apart}
    return {k: (math.inf if math.isnan(v) else v) for k, v in out.items()}


def control(cfg, run_key, lam, u0):
    """The control in the program's place: the reference in float32 with
    TF32 matrix products on, the precision below the configuration's
    float32 with TF32 off."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return run(cfg, run_key, lam, u0, dtype=torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def sized(cfg, job):
    """The configuration at the job's chains, warmup and samples."""
    return {**cfg, "num_chains": job["chains"], "num_warmup": job["warmup"],
            "num_samples": job["samples"]}


def numbers(cfg, job, got, device):
    """The numbers compared for the run ``got`` of ``job``, against the
    float64 reference run on the same draws."""
    cfg = sized(cfg, job)
    chol = factor(cfg, device)
    lam = precision(chol)
    want = run(cfg, job["key"], lam, initial_point(cfg, chol))
    return compare(cfg, job["key"], lam, got, want)


def control_numbers(cfg, spec, job, seed, device, units=None):
    """The control's numbers: ``control``'s run of the job judged in the
    program's place."""
    c = sized(cfg, job)
    chol = factor(c, device)
    got = control(c, job["key"], precision(chol), initial_point(c, chol))
    return numbers(cfg, job, got, device)
