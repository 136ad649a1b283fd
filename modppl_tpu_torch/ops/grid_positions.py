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

- ``grid_layout(nb, bw)``: the kernels' launch (threads a CTA, rows a CTA,
  lanes a row, registers a lane, CTAs) as the C launchers compute it, from
  the two ``#define`` lines of csrc/grid_positions.cu (``GRID_WARPS``,
  ``GRID_LANES``); ``strided_stats_model`` and ``word_positions_model``
  model in torch the order in which each kernel's lanes and registers
  combine a row, for the CPU tests (nothing on the main path calls them).
"""

import ctypes
import re

import torch
import torch.nn.functional as F

from modppl_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_STATS_ARGS = (_P, _P, _P, _P, _P, _I, _I, _P)
_POSITIONS_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P)
MAX_WIDTH = 1024
_INT32_MIN = -(2 ** 31)


def _compiled_launch():
    """(warps a CTA, lanes a row) as csrc/grid_positions.cu defines them."""
    src = (_build.CSRC / "grid_positions.cu").read_text()
    found = dict(re.findall(r"#define MODPPL_GRID_(WARPS|LANES) (\d+)", src))
    return int(found["WARPS"]), int(found["LANES"])


# Each row is one group of lanes: GRID_LANES (a warp) at bw >= GRID_LANES,
# else bw lanes and GRID_LANES / bw rows a warp; GRID_WARPS warps a CTA.
GRID_WARPS, GRID_LANES = _compiled_launch()


def grid_layout(nb, bw):
    """(threads a CTA, rows a CTA, lanes a row, registers a lane, CTAs) of
    kernels 1 and 2 on nb rows of width bw (csrc/grid_positions.cu)."""
    lanes = min(bw, GRID_LANES)
    rows = GRID_WARPS * (GRID_LANES // lanes)
    return 32 * GRID_WARPS, rows, lanes, bw // lanes, -(-nb // rows)


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


def _square_tree(v):
    """``square_tree`` (csrc/grid_positions.cu) on v (nb, R, W), lane l's
    register j at v[:, j, l]: the element-level pairs over the lanes,
    transposing while a lane holds more than one register (at offset o the
    lane with bit o clear keeps register 2q, the other 2q + 1, each adding
    its partner's copy), then the register level over the lanes. Returns
    every lane's result (nb, W)."""
    regs, lanes = v.shape[1:]
    lane = torch.arange(lanes)
    o = 1
    while o < lanes:
        if v.shape[1] > 1:
            upper = (lane & o) != 0
            a, b = v[:, 0::2], v[:, 1::2]
            keep, give = torch.where(upper, b, a), torch.where(upper, a, b)
            v = keep + give[..., lane ^ o]
        else:
            v = v + v[..., lane ^ o]
        o *= 2
    if v.shape[1] != 1:
        raise AssertionError("square_tree: a lane holds more than one "
                             "register after the element level")
    o = 1
    while o < regs:
        v = v + v[..., lane ^ o]
        o *= 2
    return v[:, 0]


def strided_stats_model(lw_rows, m):
    """Kernel 1's schedule (csrc/grid_positions.cu: stats_cumsum_kernel) in
    torch: lane l's register j holds element l + W j of its row; the tree
    of e*e (``_square_tree``), which must give every lane the same total;
    the scan's levels k < W as a rotate of each register by k lanes, lane
    l >= k taking the rotated register j and lane l < k the rotated
    register j - 1 (0 at j = 0); the levels k >= W as register j adding
    register j - k / W. Returns (cum, totals, sq_totals), which must equal
    ``stats_cumsum_plain`` bitwise."""
    nb, bw = lw_rows.shape
    _, _, lanes, regs, _ = grid_layout(nb, bw)
    e = torch.exp(lw_rows - m)
    sq = _square_tree((e * e).reshape(nb, regs, lanes))
    if not bool((sq == sq[:, :1]).all()):
        raise AssertionError("square_tree: the lanes of a row disagree")
    x = e.reshape(nb, regs, lanes)
    lane = torch.arange(lanes)
    k = 1
    while k < lanes:
        r = torch.roll(x, k, dims=2)  # r[..., l] = x[..., (l - k) mod W]
        before = torch.cat([torch.zeros_like(r[:, :1]), r[:, :-1]], 1)
        x = x + torch.where(lane >= k, r, before)
        k *= 2
    while k < bw:
        d = k // lanes
        x = torch.cat([x[:, :d], x[:, d:] + x[:, :-d]], 1)
        k *= 2
    return x.reshape(nb, bw), x[:, -1, -1], sq[:, -1]


def word_positions_model(cum, offs, total, u, num_particles):
    """Kernel 2's schedule (csrc/grid_positions.cu: positions_cummax_kernel)
    in torch: lane l's word q of V = min(R, 4) elements holds elements
    V (W q + l) ... V (W q + l) + V - 1 of its row; each word's running
    max; for each q an inclusive shuffle-up max scan of the word maxima over
    the lanes (a lane below the offset keeps its own); each word raised to
    the scan of the lanes before it (INT32_MIN at lane 0) and to the carry,
    the maximum of the row's words before q. Returns (s_rows, row maxima),
    which must equal ``positions_cummax_plain`` bitwise."""
    nb, bw = cum.shape
    n = num_particles
    _, _, lanes, regs, _ = grid_layout(nb, bw)
    width = min(regs, 4)
    cdf = cum + offs[:, None]
    s = torch.clamp(torch.ceil((cdf / total) * n - u), 0, n).to(torch.int32)
    run = torch.cummax(s.reshape(nb, regs // width, lanes, width), 3).values
    upto = run[..., -1]
    lane = torch.arange(lanes)
    o = 1
    while o < lanes:
        y = torch.cat([upto[..., :o], upto[..., :-o]], -1)
        upto = torch.where(lane >= o, torch.maximum(upto, y), upto)
        o *= 2
    low = upto.new_full(upto.shape[:-1] + (1,), _INT32_MIN)
    before = torch.cat([low, upto[..., :-1]], -1)
    words = torch.cummax(upto[..., -1], 1).values
    carry = torch.cat([low[:, 0], words[:, :-1]], 1)
    before = torch.maximum(before, carry[..., None])
    return (torch.maximum(run, before[..., None]).reshape(nb, bw),
            words[:, -1])


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
