"""What the two HMC chunk arms share (ops/leapfrog_small.py at d <= 12,
ops/leapfrog.py at d >= 13): the pre-drawn random streams, the accept rule,
the plain sampling loop and pooled warmup that each arm runs around its own
``transition_plain``, and the wrappers' checks and launch.

An arm's ``transition_plain(u0, p, eps, u01, lam, b, im, num_steps)``
returns (u_out, logp_out, aprob, divergent), u_out post-accept.
"""

import torch

from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.inference.adaptation import _tree_sum, slow_windows
from modppl_tpu_torch.ops import _build
from modppl_tpu_torch.utils.profiling import host_to_device

# the most slow windows the warmup kernels take (csrc/hmc_pooled.cuh)
MAX_WINDOWS = 32


# --------------------------------------------------------------------------
# random streams
# --------------------------------------------------------------------------

def phase_draws(key, num, n, d, dtype, device):
    """One phase's pre-drawn streams from ``split(key, 3)``, as the
    reference's chunk wrappers draw them from ``jax.random.split(key, 3)``:
    standard-normal momenta z (num, n, d), step-size jitters uniform in
    [0.5, 1.5) (num, n) and accept uniforms in [0, 1) (num, n)."""
    k_mom, k_jit, k_acc = split(key, 3)
    z = torch.randn((num, n, d), generator=generator(k_mom, device),
                    dtype=dtype, device=device)
    jit = torch.rand((num, n), generator=generator(k_jit, device),
                     dtype=dtype, device=device) + 0.5
    u01 = torch.rand((num, n), generator=generator(k_acc, device),
                     dtype=dtype, device=device)
    return z, jit, u01


# --------------------------------------------------------------------------
# plain versions, around an arm's transition_plain
# --------------------------------------------------------------------------

def accept_prob(delta):
    """(aprob, divergent) from the energy change, with the reference's
    divergence guard."""
    div = ~torch.isfinite(delta) | (delta < -1000.0)
    aprob = torch.where(div, 0.0, torch.clamp(
        torch.exp(torch.clamp(delta, max=0.0)), max=1.0))
    return aprob, div


def sample_plain(transition_plain, u, mom, epsj, u01, lam, b, inv_mass,
                 num_steps):
    """The whole sampling phase, one transition per row of the streams:
    (us (T, N, d), logp (T, N), aprob (T, N), divergent (T, N))."""
    us, lps, aps, dvs = [], [], [], []
    for t in range(mom.shape[0]):
        u, lp, ap, dv = transition_plain(u, mom[t], epsj[t], u01[t], lam, b,
                                         inv_mass, num_steps)
        us.append(u)
        lps.append(lp)
        aps.append(ap)
        dvs.append(dv)
    return (torch.stack(us), torch.stack(lps), torch.stack(aps),
            torch.stack(dvs))


def warmup_plain(transition_plain, u0s, z, jit, u01, lam, b, eps0, num_steps,
                 target_accept=0.8):
    """The pooled windowed warmup both chunk arms run: Nesterov dual
    averaging on the pooled accept mean (hmc.py:da_update constants, with
    eta = exp(-0.75 log t)), Chan-Welford pooled moments in slow windows,
    the variance as the new inverse mass at each slow window's end. Pooled
    sums are the adjacent-pairing tree over the chain axis (``_tree_sum``),
    the order the kernels reduce in. Every scalar stays a tensor on the
    chains' device, so this runs as the kernels' arithmetic does.
    Returns (us (N, d), eps (), inv_mass (d,))."""
    num, n, d = z.shape
    dt, dev = u0s.dtype, u0s.device

    def const(v):
        return torch.tensor(v, dtype=dt, device=dev)

    zero, c_live = const(0.0), const(float(n))
    log10 = torch.log(const(10.0))
    log_eps = torch.log(const(eps0))
    leb, hbar, t_da = log_eps, zero, zero
    mu = torch.log(const(10.0 * eps0))
    nw = zero
    mean = m2 = torch.zeros(d, dtype=dt, device=dev)
    im = torch.ones(d, dtype=dt, device=dev)
    windows = slow_windows(num)
    ends = {e for _, e in windows}
    u = u0s
    for t in range(num):
        if t in ends:
            shrink = nw / (nw + 5.0)
            var = m2 / torch.clamp(nw - 1.0, min=1.0)
            var = shrink * var + (1.0 - shrink) * 1e-3
            im = torch.clamp(var, 1e-8, 1e8)
            log_eps, mu = leb, log10 + leb
            hbar = t_da = nw = zero
            mean = m2 = torch.zeros(d, dtype=dt, device=dev)
        p = z[t] * torch.rsqrt(im)
        eps = torch.exp(log_eps) * jit[t]
        u, _, aprob, _ = transition_plain(u, p, eps, u01[t], lam, b, im,
                                          num_steps)
        a_mean = _tree_sum(aprob) / c_live
        t_da = t_da + 1.0
        eta_h = 1.0 / (t_da + 10.0)
        hbar = (1.0 - eta_h) * hbar + eta_h * (target_accept - a_mean)
        log_eps = mu - torch.sqrt(t_da) * 20.0 * hbar
        eta = torch.exp(-0.75 * torch.log(t_da))
        leb = eta * log_eps + (1.0 - eta) * leb
        if any(s <= t < e for s, e in windows):
            n_new = nw + c_live
            b_mean = _tree_sum(u) / c_live
            dv = u - b_mean
            b_m2 = _tree_sum(dv * dv)
            delta = b_mean - mean
            mean = mean + delta * c_live / n_new
            m2 = m2 + b_m2 + delta * delta * nw * c_live / n_new
            nw = n_new
    return u, torch.exp(leb), im


# --------------------------------------------------------------------------
# the wrappers' checks and launch
# --------------------------------------------------------------------------

def require(cond, name, what):
    if not cond:
        raise ValueError(f"{name}: the CUDA kernel needs {what}")


def check_f32(name, device, **tensors):
    """Every tensor float32, contiguous and on ``device``."""
    for what, t in tensors.items():
        require(t.device == device and t.dtype == torch.float32
                and t.is_contiguous(), name,
                f"{what} as a contiguous float32 tensor on {device}, got "
                f"{t.dtype} on {t.device}")


def check_quadratic(name, n, d, device, max_dim, **tensors):
    """The (Λ, b[, inv_mass]) shapes for dimension d, and 1 <= d <= max_dim."""
    require(1 <= d <= max_dim, name, f"1 <= d <= {max_dim}, got d={d}")
    require(n >= 1, name, "at least one chain")
    check_f32(name, device, **tensors)
    for what, t in tensors.items():
        want = (d, d) if what == "lam" else (d,)
        require(tuple(t.shape) == want, name, f"{what} of shape {want}")


def check_streams(name, num, n, d, mom, *per_chain):
    require(num >= 1 and tuple(mom.shape) == (num, n, d), name,
            f"momenta of shape (T, {n}, {d}) with T >= 1")
    for t in per_chain:
        require(tuple(t.shape) == (num, n), name,
                f"per-transition streams of shape ({num}, {n})")


def launch(entry, argtypes, name, device, *args):
    """Call a C entry on the current stream of ``device``; raise on error."""
    fn = _build.entry(entry, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    _build.check(err, name)


def schedule_arrays(num_warmup, device):
    """The slow windows as an int32 (2, MAX_WINDOWS) tensor [starts; ends]
    and their count."""
    windows = slow_windows(num_warmup)
    if len(windows) > MAX_WINDOWS:
        raise ValueError(f"more than {MAX_WINDOWS} slow windows")
    sch = [[0] * MAX_WINDOWS, [0] * MAX_WINDOWS]
    for i, (s, e) in enumerate(windows):
        sch[0][i], sch[1][i] = s, e
    return host_to_device(sch, torch.int32, device), len(windows)
