"""HMC on quadratic targets at larger d: the whole-phase chunks at d >= 13
(kernels 6 and 7), the leapfrog integration alone at any d to 224
(kernel 5), and the fixed-step-size API built on it.

Counterpart of modppl_tpu/ops/leapfrog_pallas.py. The target is
logp(u) = b.u - u.Λu/2 (+ const), so grad = b - uΛ. The CUDA kernels are in
csrc/hmc_chunk.cu; its header says what bounds them and how they are laid
out. All follow the reference kernels' arithmetic: per-coordinate
energies e = -u(b+g)/2 + im p^2/2, dH the sum of the finite (e0 - e1)
terms (any non-finite term marks the chain divergent), logp = u.(b+g)/2,
and the chunk kernels' gradient input clamped to +-1e30.

All three kernels run one product on one shared-memory carve-up, mirrored
here (``chunk_smem_bytes``, ``chunk_tile``, ``chunk_max_chains``) so that
the wrappers pick the tile and check the limits before a launch: Λ, two
k-major buffers of the product's input (which also serve as the warmup's
reduction scratch), one prefetched transition of streams, and per-chain
scalars (kernel 5 leaves the last two unused). Each thread of the 256
owns a 4-chain x 4-coordinate block and keeps that block's chain state in
registers, so a tile of TC chains needs TC dp <= 4096 (dp = d rounded up
to 4). TC is 64 to d = 64, 32 to d = 128, 16 or 8 above, and d = 224 is
the largest that fits.

- ``sample_chunk(u, mom, epsj, u01, lam, b, inv_mass, num_steps)``: the
  whole sampling phase from pre-drawn momenta (already scaled by
  1/sqrt(inv_mass)), jittered step sizes and accept uniforms. Returns us
  (T, N, d), logp, aprob (T, N) and divergent (T, N) bool.
- ``warmup_chunk(u0s, z, jit, u01, lam, b, eps0, num_steps,
  target_accept)``: the whole pooled windowed warmup from pre-drawn
  standard normals, jitters and uniforms; (us (N, d), eps (), inv_mass (d,)).
- ``fused_leapfrog(u, p, eps, lam, b, inv_mass, num_steps)``: (u_L, p_L)
  after L leapfrog steps (leapfrog_pallas.py:81-128); its gradient is
  b - uΛ with no clamp, as the reference kernel's.
- ``hmc_transition_quadratic`` and ``hmc_quadratic``: one transition, and
  a run of transitions at a fixed step size, one kernel launch per
  transition (``hmc_transition_small`` at d <= 7, ``fused_leapfrog``
  above, with the energies and the accept as plain torch). At d >= 8 the
  log-densities are a ``torch.matmul``, which must run in full FP32: on the
  card the transition raises while TF32 is allowed.

Each runs its kernel on CUDA tensors (float32) and its plain PyTorch version
on CPU tensors. The plain versions take the kernels' arithmetic order, and
the kernels keep it: each gradient entry is a ``torch.addcmul`` chain over
k (one fused multiply-add per term on the card, as the kernels' FFMA chain
over k = 0..d-1, never split or reordered), and sums over a chain's
coordinates are the adjacent-pairing tree (``_tree_sum``), so kernel and
plain version agree bitwise. No matmul runs, so TF32 settings cannot touch
them. ``<wrapper>.launches`` counts kernel launches. ``hmc_sample_chunk``
and ``hmc_warmup_chunk`` are the reference's key-taking entries.
"""

import ctypes
import functools

import torch

from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.inference.adaptation import _tree_sum
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
from modppl_tpu_torch.ops.leapfrog_small import (
    MAX_DIM_VPU,
    hmc_transition_small,
    per_chain,
)

# shared memory a block may take on an H100 (227 KB), less room for the
# kernels' static shared variables
MAX_SMEM = 232448 - 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SAMPLE_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                _P, _P, _P, _P, _P)
_WARMUP_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                _I, _P, _P, _I, _P, _P, _P)
_LEAPFROG_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P)


# kernels 5, 6 and 7: chains per CTA, threads per CTA (each owns 4 x 4 of the
# tile's chains x coordinates)
CHUNK_TILES = (64, 32, 16, 8)
CHUNK_THREADS = 256
CHUNK_MAX_DIM = 224


def chunk_smem_bytes(d, tile):
    """Dynamic shared memory of kernel 5's, 6's or 7's CTA holding Λ (rows 64
    floats apart at tile 64, 128 at tile 32, else dp), two k-major
    (dp, tile) input buffers (rows padded by 4 floats at tile >= 32), one
    prefetched (tile, dp) stream and the per-chain scalars
    (csrc/hmc_chunk.cu:chunk_floats)."""
    dp = -(-d // 4) * 4
    row = tile + 4 if tile >= 32 else tile
    lam_row = {64: 64, 32: 128}.get(tile, dp)
    return 4 * (dp * lam_row + 2 * dp * row + tile * dp + 6 * dp + 4
                + 7 * tile)


def chunk_tile(d):
    """Kernels 5, 6 and 7's most chains per CTA (of CHUNK_TILES) whose 4 x 4
    blocks the CTA's threads cover and whose buffers fit beside Λ in shared
    memory; raises above the largest d that fits (224)."""
    dp = -(-d // 4) * 4
    for tile in CHUNK_TILES:
        if (tile * dp <= 16 * CHUNK_THREADS
                and chunk_smem_bytes(d, tile) <= MAX_SMEM):
            return tile
    raise ValueError(f"hmc chunk kernels: d={d} does not fit in shared "
                     f"memory ({MAX_SMEM} bytes a block); the largest d is "
                     f"{CHUNK_MAX_DIM}")


def chunk_max_chains(d):
    """The most chains ``warmup_chunk`` takes at d: its tile partials are
    summed by a tree over a power of two of tiles (``ptiles``) in the two
    input buffers, 2 tile dp floats."""
    tile, dp = chunk_tile(d), -(-d // 4) * 4
    return tile * (1 << ((2 * tile * dp).bit_length() - 1))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def quadratic_logp(u, lam, b):
    """logp(u) = -1/2 u.Λu + b.u, batched over rows of u."""
    return -0.5 * torch.sum(u * (u @ lam), dim=-1) + u @ b


def _grad(u, lam, b, clamp=True):
    """b - clip(u) Λ (b - uΛ without ``clamp``), each entry one multiply-add
    chain over k in order."""
    uc = torch.clamp(u, -1e30, 1e30) if clamp else u
    acc = uc[:, 0:1] * lam[0]
    for k in range(1, u.shape[1]):
        acc = torch.addcmul(acc, uc[:, k:k + 1], lam[k])
    return b - acc


def _coord_sum(x):
    """(N, d) -> (N,): the adjacent-pairing tree over the coordinates."""
    return _tree_sum(x.T)


def _energy(u, g, p, b, im):
    """-logp + kinetic, per coordinate."""
    return (-0.5 * u) * (b + g) + ((0.5 * im) * p) * p


def transition_plain(u0, p0, eps, u01, lam, b, im, num_steps):
    """One HMC transition of every chain: u0, p0 (N, d); eps, u01 (N,).
    Returns (u_out, logp_out, aprob, divergent), u_out post-accept."""
    e = eps[:, None]
    g0 = _grad(u0, lam, b)
    e0 = _energy(u0, g0, p0, b, im)
    u, p, g = u0, p0, g0
    for _ in range(num_steps):
        p = p + (0.5 * e) * g
        u = u + (e * im) * p
        g = _grad(u, lam, b)
        p = p + (0.5 * e) * g
    e_diff = e0 - _energy(u, g, p, b, im)
    fin = torch.isfinite(e_diff)
    dh = _coord_sum(torch.where(fin, e_diff, 0.0))
    aprob, div = accept_prob(dh)
    div = div | ~fin.all(dim=1)
    aprob = torch.where(div, 0.0, aprob)
    acc = u01 < aprob
    u_out = torch.where(acc[:, None], u, u0)
    lp_elem = 0.5 * torch.where(acc[:, None], u * (b + g), u0 * (b + g0))
    lp = _coord_sum(torch.where(torch.isfinite(lp_elem), lp_elem, 0.0))
    return u_out, lp, aprob, div


# plain versions of ``sample_chunk`` and ``warmup_chunk``
sample_chunk_plain = functools.partial(sample_plain, transition_plain)
warmup_chunk_plain = functools.partial(warmup_plain, transition_plain)


def fused_leapfrog_plain(u, p, eps, lam, b, inv_mass, num_steps):
    """``num_steps`` leapfrog steps of every chain (leapfrog_pallas.py:57-63):
    u, p (N, d), eps (N,). The gradient b - uΛ is not clamped. Returns
    (u_L, p_L)."""
    e = eps[:, None]
    g = _grad(u, lam, b, clamp=False)
    for _ in range(num_steps):
        p = p + (0.5 * e) * g
        u = u + (e * inv_mass) * p
        g = _grad(u, lam, b, clamp=False)
        p = p + (0.5 * e) * g
    return u, p


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def sample_chunk(u, mom, epsj, u01, lam, b, inv_mass, num_steps):
    """(us (T, N, d), logp (T, N), aprob (T, N), divergent (T, N) bool)."""
    if u.device.type == "cpu":
        return sample_chunk_plain(u, mom, epsj, u01, lam, b, inv_mass,
                                  num_steps)
    name = "hmc_sample_chunk"
    n, d = u.shape
    num = mom.shape[0]
    tile = chunk_tile(d)
    check_quadratic(name, n, d, u.device, d, lam=lam, b=b, inv_mass=inv_mass)
    check_f32(name, u.device, u=u, mom=mom, epsj=epsj, u01=u01)
    check_streams(name, num, n, d, mom, epsj, u01)
    require(num_steps >= 0, name, "num_steps >= 0")
    us = torch.empty(num, n, d, dtype=torch.float32, device=u.device)
    lps = torch.empty(num, n, dtype=torch.float32, device=u.device)
    aps = torch.empty_like(lps)
    dvs = torch.empty(num, n, dtype=torch.bool, device=u.device)
    launch("modppl_hmc_sample_chunk_f32", _SAMPLE_ARGS, name, u.device,
           u.data_ptr(), mom.data_ptr(), epsj.data_ptr(), u01.data_ptr(),
           lam.data_ptr(), b.data_ptr(), inv_mass.data_ptr(), n, d, num,
           num_steps, tile, us.data_ptr(), lps.data_ptr(), aps.data_ptr(),
           dvs.data_ptr())
    sample_chunk.launches += 1
    return us, lps, aps, dvs


def warmup_chunk(u0s, z, jit, u01, lam, b, eps0, num_steps,
                 target_accept=0.8):
    """(us (N, d), eps (), inv_mass (d,)) after the whole pooled warmup."""
    if u0s.device.type == "cpu":
        return warmup_chunk_plain(u0s, z, jit, u01, lam, b, eps0, num_steps,
                                  target_accept)
    name = "hmc_warmup_chunk"
    n, d = u0s.shape
    num = z.shape[0]
    tile = chunk_tile(d)
    check_quadratic(name, n, d, u0s.device, d, lam=lam, b=b)
    check_f32(name, u0s.device, u0s=u0s, z=z, jit=jit, u01=u01)
    check_streams(name, num, n, d, z, jit, u01)
    require(num_steps >= 0 and eps0 > 0, name, "num_steps >= 0, eps0 > 0")
    ptiles = 1 << (-(-n // tile) - 1).bit_length()
    require(n <= chunk_max_chains(d), name,
            f"at most {chunk_max_chains(d)} chains at d={d}")
    sch, nwin = schedule_arrays(num, u0s.device)
    us = u0s.clone()
    part = torch.zeros(2, 1 + 2 * d, ptiles, dtype=torch.float32,
                       device=u0s.device)
    eps = torch.empty((), dtype=torch.float32, device=u0s.device)
    im = torch.empty(d, dtype=torch.float32, device=u0s.device)
    launch("modppl_hmc_warmup_chunk_f32", _WARMUP_ARGS, name, u0s.device,
           us.data_ptr(), z.data_ptr(), jit.data_ptr(), u01.data_ptr(),
           lam.data_ptr(), b.data_ptr(), n, d, num, num_steps, float(eps0),
           float(10.0 * eps0), float(target_accept), nwin, sch.data_ptr(),
           part.data_ptr(), tile, eps.data_ptr(), im.data_ptr())
    warmup_chunk.launches += 1
    return us, eps, im


def fused_leapfrog(u, p, eps, lam, b, inv_mass, num_steps):
    """(u_L, p_L) after ``num_steps`` leapfrog steps; eps (N,) or a scalar."""
    n, d = u.shape
    eps = per_chain(eps, n, u)
    if u.device.type == "cpu":
        return fused_leapfrog_plain(u, p, eps, lam, b, inv_mass, num_steps)
    name = "fused_leapfrog"
    tile = chunk_tile(d)
    check_quadratic(name, n, d, u.device, d, lam=lam, b=b, inv_mass=inv_mass)
    check_f32(name, u.device, u=u, p=p)
    require(tuple(p.shape) == (n, d), name, f"p of shape ({n}, {d})")
    require(num_steps >= 0, name, "num_steps >= 0")
    u_out, p_out = torch.empty_like(u), torch.empty_like(u)
    launch("modppl_fused_leapfrog_f32", _LEAPFROG_ARGS, name, u.device,
           u.data_ptr(), p.data_ptr(), eps.data_ptr(), lam.data_ptr(),
           b.data_ptr(), inv_mass.data_ptr(), n, d, num_steps, tile,
           u_out.data_ptr(), p_out.data_ptr())
    fused_leapfrog.launches += 1
    return u_out, p_out


sample_chunk.launches = 0
warmup_chunk.launches = 0
fused_leapfrog.launches = 0


# --------------------------------------------------------------------------
# key-taking entries (the reference's API)
# --------------------------------------------------------------------------

def hmc_sample_chunk(key, u, eps, lam, b, inv_mass, num_samples, num_steps,
                     draws=None):
    """``num_samples`` transitions in one launch; momenta z / sqrt(inv_mass),
    step sizes eps * jitter. ``draws`` = (z, jit, u01) replaces the streams
    drawn from ``key``. Returns (us (T, N, d), logps, aprobs, divs (T, N))."""
    n, d = u.shape
    z, jit, u01 = draws if draws is not None else phase_draws(
        key, num_samples, n, d, u.dtype, u.device)
    return sample_chunk(u, z / torch.sqrt(inv_mass), eps * jit, u01, lam, b,
                        inv_mass, num_steps)


def hmc_warmup_chunk(key, u0s, eps0, lam, b, num_warmup, num_steps,
                     target_accept=0.8, draws=None):
    """The whole pooled warmup in one launch; (us, eps, inv_mass)."""
    n, d = u0s.shape
    z, jit, u01 = draws if draws is not None else phase_draws(
        key, num_warmup, n, d, u0s.dtype, u0s.device)
    return warmup_chunk(u0s, z, jit, u01, lam, b, eps0, num_steps,
                        target_accept)


# --------------------------------------------------------------------------
# one transition per launch: the fixed-step-size API
# --------------------------------------------------------------------------

def _tf32_on():
    return bool(torch.backends.cuda.matmul.allow_tf32)


def require_full_fp32(device):
    """Raise if a float32 matmul on ``device`` may run in TF32: the accept
    ratio comes from ``quadratic_logp``'s product, and TF32 would bias it
    (the reference pins Precision.HIGHEST, leapfrog_pallas.py:143-148)."""
    if torch.device(device).type == "cuda" and _tf32_on():
        raise RuntimeError(
            "hmc_transition_quadratic: torch.backends.cuda.matmul.allow_tf32 "
            "is on; the accept ratio needs full-FP32 products (set it to "
            "False, or torch.set_float32_matmul_precision('highest'))")


def hmc_transition_quadratic(key, u, eps, lam, b, inv_mass, num_leapfrog,
                             draws=None):
    """One HMC transition of every chain on the quadratic target
    (leapfrog_pallas.py:151-190): momenta z / sqrt(inv_mass), then at
    d <= 7 the whole transition in one launch (``hmc_transition_small``),
    above it ``fused_leapfrog`` with the energies, the divergence guard,
    min(1, exp(dH)) and the select as plain torch. ``draws`` = (z (N, d),
    u01 (N,)) replaces the streams drawn from ``split(key)``. Returns
    (u', logp(u'), accept_prob, divergent) per chain."""
    n, d = u.shape
    if draws is None:
        k_mom, k_acc = split(key)
        z = torch.randn((n, d), generator=generator(k_mom, u.device),
                        dtype=u.dtype, device=u.device)
        u01 = torch.rand((n,), generator=generator(k_acc, u.device),
                         dtype=u.dtype, device=u.device)
    else:
        z, u01 = draws
    p0 = z / torch.sqrt(inv_mass)
    if d <= MAX_DIM_VPU:
        (u_out, _), logp_out, aprob, divergent, _, _ = hmc_transition_small(
            u, p0, eps, u01, lam, b, inv_mass, num_leapfrog)
        return u_out, logp_out, aprob, divergent
    require_full_fp32(u.device)
    u1, p1 = fused_leapfrog(u, p0, eps, lam, b, inv_mass, num_leapfrog)
    logp0 = quadratic_logp(u, lam, b)
    logp1 = quadratic_logp(u1, lam, b)
    h0 = -logp0 + 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    h1 = -logp1 + 0.5 * torch.sum(inv_mass * p1 * p1, dim=-1)
    delta_h = h0 - h1
    divergent = ~torch.isfinite(delta_h) | (delta_h < -1000.0)
    aprob = torch.where(divergent, 0.0,
                        torch.clamp(torch.exp(delta_h), max=1.0))
    accept = u01 < aprob
    u_out = torch.where(accept[:, None], u1, u)
    logp_out = torch.where(accept, logp1, logp0)
    return u_out, logp_out, aprob, divergent


def hmc_quadratic(key, u0, lam, b, inv_mass, *, step_size, num_samples,
                  num_leapfrog, draws=None):
    """Fixed-step-size HMC on the quadratic target (leapfrog_pallas.py:
    663-684): ``num_samples`` transitions, one ``hmc_transition_quadratic``
    (one kernel launch) each, with per-chain step sizes step_size * jitter.
    The streams come from ``phase_draws(key)``: momenta z (T, N, d),
    jitters in [0.5, 1.5) and accept uniforms (T, N); ``draws`` = (z, jit,
    u01) replaces them. Returns a dict of ``samples`` (T, N, d), ``logp``,
    ``accept_prob`` and ``divergences`` (T, N)."""
    n, d = u0.shape
    z, jit, u01 = draws if draws is not None else phase_draws(
        key, num_samples, n, d, u0.dtype, u0.device)
    u, us, logps, aprobs, divs = u0, [], [], [], []
    for t in range(num_samples):
        u, logp, aprob, div = hmc_transition_quadratic(
            None, u, step_size * jit[t], lam, b, inv_mass, num_leapfrog,
            draws=(z[t], u01[t]))
        us.append(u)
        logps.append(logp)
        aprobs.append(aprob)
        divs.append(div)
    return {"samples": torch.stack(us), "logp": torch.stack(logps),
            "accept_prob": torch.stack(aprobs),
            "divergences": torch.stack(divs)}
