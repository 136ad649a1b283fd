"""Blocked systematic-resampling grid positions: kernels 1 and 2.

Counterpart of modppl_tpu/ops/grid_positions_pallas.py. The CUDA kernels
are in csrc/grid_positions.cu; its header says what bounds them and how
they keep the reference's add order.

- ``stats_cumsum(lw_rows, m)``: per row of width bw, the inclusive
  Hillis-Steele cumsum of e = exp(lw - m), the row total of e and the
  scanned row total of e*e.
- ``positions_cummax(cum, offs, total, u, n)``: S = clip(ceil((cdf/total)*n
  - u), 0, n) as int32 with cdf = cum + offs, the in-row integer cummax and
  the row maxima (the cross-row repair is the caller's, in plain torch).

Each wrapper runs its kernel on a CUDA tensor (or raises on a shape or dtype
the kernel does not take) and its plain PyTorch version on a CPU tensor.
``<wrapper>.launches`` counts kernel launches.
"""

import ctypes

import torch
import torch.nn.functional as F

from modppl_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_STATS_ARGS = (_P, _P, _P, _P, _P, _I, _I, _P)
_POSITIONS_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P)
MAX_WIDTH = 1024


def doubling_cumsum(x):
    """Inclusive cumsum along the last axis with the FIXED Hillis-Steele
    shift-add structure: at levels k = 1, 2, ..., x[i] += x[i-k]."""
    n = x.shape[-1]
    k = 1
    while k < n:
        x = x + F.pad(x, (k, 0))[..., :n]
        k *= 2
    return x


def stats_cumsum_plain(lw_rows, m):
    """Plain version of ``stats_cumsum``: the reference's XLA path
    (sharded_smc.py:138-148), with e and e*e scanned in one stacked pass."""
    e = torch.exp(lw_rows - m)
    c2 = doubling_cumsum(torch.stack([e, e * e]))
    return c2[0], c2[0, :, -1], c2[1, :, -1]


def positions_cummax_plain(cum, offs, total, u, num_particles):
    """Plain version of ``positions_cummax`` (sharded_smc.py:179-182 per row)."""
    n = num_particles
    cdf = cum + offs[:, None]
    s = torch.clamp(torch.ceil((cdf / total) * n - u), 0, n).to(torch.int32)
    s_rows = torch.cummax(s, dim=1).values
    return s_rows, s_rows[:, -1]


def _require(cond, name, what):
    if not cond:
        raise ValueError(f"{name}: the CUDA kernel needs {what}")


def _check_scalar(name, what, t, device):
    _require(torch.is_tensor(t) and t.device == device
             and t.dtype == torch.float32 and t.numel() == 1,
             name, f"{what} as a one-element float32 tensor on {device}")


def _check_rows(name, t, dtype):
    _require(t.is_cuda, name, "a CUDA tensor")
    _require(t.dtype == dtype, name, f"{dtype}, got {t.dtype}")
    _require(t.ndim == 2 and t.is_contiguous(), name,
             "a contiguous (nb, bw) tensor")
    nb, bw = t.shape
    _require(nb >= 1 and 1 <= bw <= MAX_WIDTH and bw & (bw - 1) == 0, name,
             f"nb >= 1 rows of a power-of-two width <= {MAX_WIDTH}, "
             f"got {tuple(t.shape)}")


def stats_cumsum(lw_rows, m):
    """(cum (nb, bw), totals (nb,), sq_totals (nb,)) of e = exp(lw - m)."""
    if lw_rows.device.type == "cpu":
        return stats_cumsum_plain(lw_rows, m)
    name = "stats_cumsum"
    _check_rows(name, lw_rows, torch.float32)
    _check_scalar(name, "m", m, lw_rows.device)
    nb, bw = lw_rows.shape
    cum = torch.empty_like(lw_rows)
    tot = torch.empty(nb, dtype=torch.float32, device=lw_rows.device)
    sqtot = torch.empty_like(tot)
    fn = _build.entry("modppl_stats_cumsum_f32", _STATS_ARGS)
    with torch.cuda.device(lw_rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lw_rows.data_ptr(), m.data_ptr(), cum.data_ptr(),
                 tot.data_ptr(), sqtot.data_ptr(), nb, bw, stream)
    _build.check(err, name)
    stats_cumsum.launches += 1
    return cum, tot, sqtot


def positions_cummax(cum, offs, total, u, num_particles):
    """(s_rows (nb, bw) int32 with the in-row cummax, mx (nb,) row maxima)."""
    if cum.device.type == "cpu":
        return positions_cummax_plain(cum, offs, total, u, num_particles)
    name = "positions_cummax"
    _check_rows(name, cum, torch.float32)
    nb, bw = cum.shape
    _require(offs.device == cum.device and offs.dtype == torch.float32
             and offs.shape == (nb,) and offs.is_contiguous(), name,
             f"offs as a contiguous ({nb},) float32 tensor on {cum.device}")
    _check_scalar(name, "total", total, cum.device)
    _check_scalar(name, "u", u, cum.device)
    _require(0 < num_particles < 2 ** 24, name,
             "0 < num_particles < 2^24 (exact in float32)")
    s_rows = torch.empty(nb, bw, dtype=torch.int32, device=cum.device)
    mx = torch.empty(nb, dtype=torch.int32, device=cum.device)
    fn = _build.entry("modppl_positions_cummax_f32", _POSITIONS_ARGS)
    with torch.cuda.device(cum.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(cum.data_ptr(), offs.data_ptr(), total.data_ptr(),
                 u.data_ptr(), s_rows.data_ptr(), mx.data_ptr(), nb, bw,
                 num_particles, stream)
    _build.check(err, name)
    positions_cummax.launches += 1
    return s_rows, mx


stats_cumsum.launches = 0
positions_cummax.launches = 0
