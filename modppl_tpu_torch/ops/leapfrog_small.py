"""HMC on quadratic targets at small d: the whole-phase chunks at d <= 12
(kernels 9 and 10) and one whole transition at d <= 7 (kernel 8).

Counterpart of modppl_tpu/ops/leapfrog_vpu_pallas.py. The target is
logp(u) = b.u - u.Λu/2 (+ const), so grad = b - Λu and a whole HMC
transition (leapfrog, Hamiltonians, Metropolis accept) needs no autograd.
The CUDA kernels are in csrc/hmc_small.cu; its header says what bounds
them and how they keep the plain versions' arithmetic order.

- ``sample_chunk_small(u, mom, epsj, u01, lam, b, inv_mass, num_steps)``:
  the whole sampling phase, T = ``mom.shape[0]`` transitions, from
  pre-drawn momenta (already scaled by 1/sqrt(inv_mass)), jittered step
  sizes and accept uniforms. Returns us (T, N, d), logp, aprob (T, N) and
  divergent (T, N) bool.
- ``warmup_chunk_small(u0s, z, jit, u01, lam, b, eps0, num_steps,
  target_accept)``: the whole pooled windowed warmup from pre-drawn
  STANDARD normals ``z`` (the kernel scales them by the evolving
  1/sqrt(inv_mass)), step-size jitters and accept uniforms. Returns
  (us (N, d), eps (), inv_mass (d,)).
- ``hmc_transition_small(u, p, eps, u01, lam, b, inv_mass, num_steps)``:
  one transition from given momenta, step sizes and accept uniforms
  (leapfrog_vpu_pallas.py:165-217); returns ((u_out, p_end), logp, aprob,
  divergent, h0, h1). ``hmc_transition_quadratic`` (ops/leapfrog.py) calls
  it at d <= 7, one launch per transition.

Each runs its kernel on CUDA tensors (float32; it raises on what the kernel
does not take) and its plain PyTorch version on CPU tensors (any float
dtype). ``<wrapper>.launches`` counts kernel launches: one per call.
``hmc_sample_chunk_small`` and ``hmc_warmup_chunk_small`` are the
reference's key-taking entries: they draw the streams from
``torch.Generator``s on the tensors' device (``phase_draws``).
"""

import ctypes
import functools

import torch

from modppl_tpu_torch.ops._hmc_common import (
    accept_prob,
    check_f32,
    check_quadratic,
    check_streams,
    launch,
    phase_draws,
    require,
    sample_plain,
    schedule_arrays,
    warmup_plain,
)

MAX_DIM = 12
# the single-transition kernel's largest d (leapfrog_vpu_pallas.MAX_DIM_VPU):
# hmc_transition_quadratic takes it at d <= 7 and fused_leapfrog above
MAX_DIM_VPU = 7
# chains per block of the warmup kernel (its in-block reduction tile), and
# the most tiles its cross-block reduction takes
WARMUP_TILE = 256
MAX_WARMUP_TILES = 1024
# the sampling kernel's chains a block and the depth of its ring of stream
# slots, and the single-transition kernel's chains a block
# (csrc/hmc_small.cu: kSampleBlock, kStages, kTransitionBlock)
SAMPLE_BLOCK = 32
SAMPLE_STAGES = 4
TRANSITION_BLOCK = 128
# shared memory a block may hold on the card (dynamic above 48 KB)
MAX_SMEM = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SAMPLE_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                _P, _P, _P, _P, _P)
_WARMUP_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                _I, _P, _P, _P, _P, _P)
_TRANSITION_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                    _P, _P, _P, _P, _P, _P, _P, _P)


# --------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# --------------------------------------------------------------------------

def _grad(u, lam, b):
    """b - Λu per chain; the sum over k runs in order 0..d-1."""
    d = u.shape[1]
    acc = u[:, 0:1] * lam[:, 0]
    for k in range(1, d):
        acc = acc + u[:, k:k + 1] * lam[:, k]
    return b - acc


def _seq_sum(cols):
    """Left-to-right sum of a list of (N,) tensors."""
    s = cols[0]
    for c in cols[1:]:
        s = s + c
    return s


def _logp(u, lam, b):
    """b.u - 0.5 * sum_jk (Λjk u_j) u_k, each sum in index order."""
    d = u.shape[1]
    terms = (lam * u[:, :, None]) * u[:, None, :]          # (N, d, d)
    quad = _seq_sum([terms[:, j, k] for j in range(d) for k in range(d)])
    lin = _seq_sum([b[j] * u[:, j] for j in range(d)])
    return lin - 0.5 * quad


def _kinetic(p, im):
    t = (im * p) * p
    return 0.5 * _seq_sum([t[:, j] for j in range(p.shape[1])])


def transition_small_plain(u0, p, eps, u01, lam, b, im, num_steps):
    """One HMC transition of every chain in _transition_core's order
    (leapfrog_vpu_pallas.py:85-145): u0, p (N, d); eps, u01 (N,). Returns
    ((u_out, p_end), logp_out, aprob, divergent, h0, h1), u_out
    post-accept, p_end the trajectory's end momentum."""
    logp0 = _logp(u0, lam, b)
    h0 = -logp0 + _kinetic(p, im)
    e = eps[:, None]
    he = 0.5 * e
    ei = e * im
    u = u0
    g = _grad(u, lam, b)
    for _ in range(num_steps):
        p = p + he * g
        u = u + ei * p
        g = _grad(u, lam, b)
        p = p + he * g
    logp1 = _logp(u, lam, b)
    h1 = -logp1 + _kinetic(p, im)
    aprob, div = accept_prob(h0 - h1)
    acc = u01 < aprob
    return ((torch.where(acc[:, None], u, u0), p),
            torch.where(acc, logp1, logp0), aprob, div, h0, h1)


def transition_plain(u0, p, eps, u01, lam, b, im, num_steps):
    """(u_out, logp_out, aprob, divergent) of ``transition_small_plain``:
    the transition the chunk kernels loop over."""
    (u_out, _), lp, ap, dv, _, _ = transition_small_plain(
        u0, p, eps, u01, lam, b, im, num_steps)
    return u_out, lp, ap, dv


# plain versions of ``sample_chunk_small`` and ``warmup_chunk_small``
sample_chunk_small_plain = functools.partial(sample_plain, transition_plain)
warmup_chunk_small_plain = functools.partial(warmup_plain, transition_plain)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def sample_layout(d):
    """The sampling kernel's launch at dimension d: (chains a block, ring
    depth, shared bytes). Each thread keeps its chain's next
    ``stages - 1`` transitions' streams (d momenta, the step size, the
    accept uniform) in a ring of ``stages`` slots of dynamic shared memory
    (the launch opts in above 48 KB); Λ, b and inv_mass sit in registers."""
    return (SAMPLE_BLOCK, SAMPLE_STAGES,
            4 * SAMPLE_STAGES * (d + 2) * SAMPLE_BLOCK)


def sample_chunk_small(u, mom, epsj, u01, lam, b, inv_mass, num_steps):
    """(us (T, N, d), logp (T, N), aprob (T, N), divergent (T, N) bool)."""
    if u.device.type == "cpu":
        return sample_chunk_small_plain(u, mom, epsj, u01, lam, b, inv_mass,
                                        num_steps)
    name = "hmc_sample_chunk_small"
    n, d = u.shape
    num = mom.shape[0]
    check_quadratic(name, n, d, u.device, MAX_DIM, lam=lam, b=b,
                    inv_mass=inv_mass)
    check_f32(name, u.device, u=u, mom=mom, epsj=epsj, u01=u01)
    check_streams(name, num, n, d, mom, epsj, u01)
    require(num_steps >= 0, name, "num_steps >= 0")
    _, _, smem = sample_layout(d)
    require(smem <= MAX_SMEM, name, f"at most {MAX_SMEM} bytes of shared "
            f"memory a block, got {smem}")
    us = torch.empty(num, n, d, dtype=torch.float32, device=u.device)
    lps = torch.empty(num, n, dtype=torch.float32, device=u.device)
    aps = torch.empty_like(lps)
    dvs = torch.empty(num, n, dtype=torch.bool, device=u.device)
    launch("modppl_hmc_sample_small_f32", _SAMPLE_ARGS, name, u.device,
           u.data_ptr(), mom.data_ptr(), epsj.data_ptr(), u01.data_ptr(),
           lam.data_ptr(), b.data_ptr(), inv_mass.data_ptr(), n, d, num,
           num_steps, us.data_ptr(), lps.data_ptr(), aps.data_ptr(),
           dvs.data_ptr())
    sample_chunk_small.launches += 1
    return us, lps, aps, dvs


def warmup_chunk_small(u0s, z, jit, u01, lam, b, eps0, num_steps,
                       target_accept=0.8):
    """(us (N, d), eps (), inv_mass (d,)) after the whole pooled warmup."""
    if u0s.device.type == "cpu":
        return warmup_chunk_small_plain(u0s, z, jit, u01, lam, b, eps0,
                                        num_steps, target_accept)
    name = "hmc_warmup_chunk_small"
    n, d = u0s.shape
    num = z.shape[0]
    check_quadratic(name, n, d, u0s.device, MAX_DIM, lam=lam, b=b)
    check_f32(name, u0s.device, u0s=u0s, z=z, jit=jit, u01=u01)
    check_streams(name, num, n, d, z, jit, u01)
    ntiles = -(-n // WARMUP_TILE)
    require(ntiles <= MAX_WARMUP_TILES, name,
            f"at most {MAX_WARMUP_TILES * WARMUP_TILE} chains")
    require(num_steps >= 0 and eps0 > 0, name, "num_steps >= 0, eps0 > 0")
    sch, nwin = schedule_arrays(num, u0s.device)
    us = u0s.clone()
    ptiles = 1 << (ntiles - 1).bit_length()
    # [parity][row][tile] partial sums; rows: aprob, d coordinate sums, d
    # squared-deviation sums; tiles past ntiles stay 0
    part = torch.zeros(2, 1 + 2 * d, ptiles, dtype=torch.float32,
                       device=u0s.device)
    eps = torch.empty((), dtype=torch.float32, device=u0s.device)
    im = torch.empty(d, dtype=torch.float32, device=u0s.device)
    launch("modppl_hmc_warmup_small_f32", _WARMUP_ARGS, name, u0s.device,
           us.data_ptr(), z.data_ptr(), jit.data_ptr(), u01.data_ptr(),
           lam.data_ptr(), b.data_ptr(), n, d, num, num_steps, float(eps0),
           float(10.0 * eps0), float(target_accept), nwin, sch.data_ptr(),
           part.data_ptr(), eps.data_ptr(), im.data_ptr())
    warmup_chunk_small.launches += 1
    return us, eps, im


def per_chain(eps, n, like):
    """A step size (number, 0-dim or (N,)) as a contiguous (N,) tensor of
    ``like``'s dtype on its device."""
    eps = torch.as_tensor(eps, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(eps.reshape(-1), (n,)).contiguous()


def hmc_transition_small(u, p, eps, u01, lam, b, inv_mass, num_steps):
    """One whole HMC transition (minus the draws) at d <= 7: u, p (N, d),
    eps (N,) or a scalar, u01 (N,). Returns ((u_out, p_end), logp_out,
    aprob, divergent, h0, h1)."""
    n, d = u.shape
    eps = per_chain(eps, n, u)
    if u.device.type == "cpu":
        return transition_small_plain(u, p, eps, u01, lam, b, inv_mass,
                                      num_steps)
    name = "hmc_transition_small"
    check_quadratic(name, n, d, u.device, MAX_DIM_VPU, lam=lam, b=b,
                    inv_mass=inv_mass)
    check_f32(name, u.device, u=u, p=p, u01=u01)
    require(tuple(p.shape) == (n, d) and tuple(u01.shape) == (n,), name,
            f"p of shape ({n}, {d}) and u01 of shape ({n},)")
    require(num_steps >= 0, name, "num_steps >= 0")
    u_out, p_out = torch.empty_like(u), torch.empty_like(u)
    lps, aps, h0s, h1s = (torch.empty_like(eps) for _ in range(4))
    dvs = torch.empty(n, dtype=torch.bool, device=u.device)
    launch("modppl_hmc_transition_small_f32", _TRANSITION_ARGS, name,
           u.device, u.data_ptr(), p.data_ptr(), eps.data_ptr(),
           u01.data_ptr(), lam.data_ptr(), b.data_ptr(), inv_mass.data_ptr(),
           n, d, num_steps, u_out.data_ptr(), p_out.data_ptr(),
           lps.data_ptr(), aps.data_ptr(), dvs.data_ptr(), h0s.data_ptr(),
           h1s.data_ptr())
    hmc_transition_small.launches += 1
    return (u_out, p_out), lps, aps, dvs, h0s, h1s


def fused_leapfrog_small(u, p, eps, lam, b, inv_mass, num_steps):
    """Integration only (leapfrog_vpu_pallas.py:393-405): the transition
    with always-accepting uniforms, so u_out is the trajectory's end.
    Returns (u_L, p_L, h0, h1)."""
    u01 = torch.full((u.shape[0],), -1.0, dtype=u.dtype, device=u.device)
    (uo, po), _, _, _, h0, h1 = hmc_transition_small(
        u, p, eps, u01, lam, b, inv_mass, num_steps)
    return uo, po, h0, h1


sample_chunk_small.launches = 0
warmup_chunk_small.launches = 0
hmc_transition_small.launches = 0


# --------------------------------------------------------------------------
# key-taking entries (the reference's API)
# --------------------------------------------------------------------------

def hmc_sample_chunk_small(key, u, eps, lam, b, inv_mass, num_samples,
                           num_steps, draws=None):
    """``num_samples`` transitions in one launch. Momenta are
    z / sqrt(inv_mass), step sizes eps * jitter, as the reference draws
    them. ``draws`` = (z, jit, u01) replaces the streams drawn from ``key``.
    Returns (us (T, N, d), logps, aprobs, divs (T, N), u_final (N, d))."""
    n, d = u.shape
    z, jit, u01 = draws if draws is not None else phase_draws(
        key, num_samples, n, d, u.dtype, u.device)
    mom = z / torch.sqrt(inv_mass)
    us, lps, aps, dvs = sample_chunk_small(u, mom, eps * jit, u01, lam, b,
                                           inv_mass, num_steps)
    return us, lps, aps, dvs, us[-1]


def hmc_warmup_chunk_small(key, u0s, eps0, lam, b, num_warmup, num_steps,
                           target_accept=0.8, draws=None):
    """The whole pooled warmup in one launch; (us, eps, inv_mass)."""
    n, d = u0s.shape
    z, jit, u01 = draws if draws is not None else phase_draws(
        key, num_warmup, n, d, u0s.dtype, u0s.device)
    return warmup_chunk_small(u0s, z, jit, u01, lam, b, eps0, num_steps,
                              target_accept)
