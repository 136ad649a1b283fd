"""Systematic-resampling ancestors from sorted slot positions: kernel 4.

Counterpart of modppl_tpu/ops/resample_pallas.py (Pallas kernel
``grid_rank``, entry ``systematic_parents_pallas``). The CUDA kernel is in
csrc/grid_rank.cu and its rank step, shared with kernel 3, in
csrc/rank.cuh: a merge path over the slots and S, each CTA an equal tile
of the merged sequence, its window's runs of equal S marked in shared
memory and turned into ranks by a running maximum; the headers say what
bounds it.

- ``grid_rank(s, n_in, num=None)``: parents[i] = #{j : S_j <= i} for the
  ``num`` output slots (default ``s.shape[0]``), clipped to [0, n_in - 1],
  from S (M,) int32 sorted in [0, num]. On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs ``grid_rank_plain``, the
  reference's integer scatter-add + cumsum (parallel/resample.py:44-46).
  ``grid_rank.launches`` counts kernel launches.
- ``rank_layout(num, m)``: the rank step's launch (threads a block, items a
  thread, blocks) as the C launchers compute it, from the tile that
  ``RANK_THREADS`` and ``RANK_ITEMS`` read out of csrc/rank.cuh;
  ``merge_path_parents(s, n_in, num)`` models in torch the splits, run
  marks and running maximum each CTA computes, for the CPU tests.
- ``slot_positions(cdf, u, num)``: S = cummax(clip(ceil(num cdf - u), 0,
  num)), the sorted first-child slot of each particle.
- ``systematic_parents(key, lw, num=None, u=None)``: the counterpart of
  ``systematic_parents_pallas`` and of ``parallel/resample.
  systematic_parents`` (which re-exports it): the single uniform from
  ``key`` (or ``u``), the normalized CDF, S, then ``grid_rank``.
"""

import ctypes
import re

import torch

from modppl_tpu_torch.core.keys import generator
from modppl_tpu_torch.ops import _build
from modppl_tpu_torch.utils.numerics import normalized_cdf

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _I, _I, _I, _P, _P)


def _compiled_tile():
    """(kRankThreads, kRankItems) as csrc/rank.cuh defines them."""
    src = (_build.CSRC / "rank.cuh").read_text()
    found = dict(re.findall(r"#define MODPPL_RANK_(THREADS|ITEMS) (\d+)", src))
    return int(found["THREADS"]), int(found["ITEMS"])


# The rank step's tile, read from csrc/rank.cuh: each CTA of kernels 3 and 4
# covers RANK_SLOTS slots of the output, RANK_THREADS groups of RANK_ITEMS
# aligned to RANK_ITEMS, and takes one group fewer items of the merged
# sequence of slots and S entries (kRankTile), so that its slots always fit.
RANK_THREADS, RANK_ITEMS = _compiled_tile()
RANK_SLOTS = RANK_THREADS * RANK_ITEMS
RANK_TILE = RANK_SLOTS - RANK_ITEMS


def uniform(key, like, shape=()):
    """Uniforms in [0, 1) of ``like``'s dtype on its device, from the
    stream of ``key``."""
    return torch.rand(shape, generator=generator(key, like.device),
                      dtype=like.dtype, device=like.device)


_ROW = 1024
_INT32_MIN = -(2 ** 31)


def int_cummax(s):
    """Running maximum of the int32 ``s`` along its last axis: within rows
    of 1024, then each row raised to the maximum of the rows before it (the
    same integers as one cummax). A 1-D ``torch.cummax`` on the card scans
    the whole vector in a single block (PERF.md has both times)."""
    n = s.shape[-1]
    lead = tuple(s.shape[:-1])
    if n <= _ROW:
        return torch.cummax(s, -1).values
    rows = -(-n // _ROW)
    if rows * _ROW != n:
        s = torch.cat([s, s.new_full(lead + (rows * _ROW - n,), _INT32_MIN)],
                      dim=-1)
    inner = torch.cummax(s.reshape(lead + (rows, _ROW)), -1).values
    prev = int_cummax(inner[..., -1].contiguous())
    prev = torch.cat([prev.new_full(lead + (1,), _INT32_MIN),
                      prev[..., :-1]], dim=-1)
    return torch.maximum(inner, prev[..., None]).reshape(lead + (-1,))[..., :n]


def slot_positions(cdf, u, num):
    """Sorted slot positions S (int32, in [0, num]) of the systematic grid
    (u + arange(num)) / num against ``cdf`` (along its last axis; ``u``
    one uniform a row). The integer cummax repairs a CDF that a parallel
    prefix sum left locally non-monotone, as the reference does in every
    systematic formulation."""
    s = torch.clamp(torch.ceil(cdf * num - u), 0, num).to(torch.int32)
    return int_cummax(s)


def grid_rank_plain(s, n_in, num=None):
    """Plain version: scatter-add of S, clipped to [0, num], into num + 1
    bins along its last axis, then a cumsum: parents (..., num), ``#{j :
    S_j <= i}`` clipped to [0, n_in - 1]. Each row of S ranks alone."""
    num = s.shape[-1] if num is None else num
    s = torch.clamp(s, 0, num).long()
    z = torch.zeros(tuple(s.shape[:-1]) + (num + 1,), dtype=torch.int64,
                    device=s.device).scatter_add_(-1, s, torch.ones_like(s))
    return torch.clamp(torch.cumsum(z[..., :num], -1), 0,
                       n_in - 1).to(torch.int32)


def rank_layout(num, m):
    """(threads a block, items a thread, blocks) of the rank step over
    ``num`` slots and ``m`` entries of S (csrc/rank.cuh: rank_blocks)."""
    return RANK_THREADS, RANK_ITEMS, -(-(num + m) // RANK_TILE)


def _warp_split(g, num, d):
    """``merge_split`` (csrc/rank.cuh) for each diagonal in ``d``:
    #{j : g_j < d} for the strictly increasing g_j = S_j + j, by rounds of
    32 probes over [lo, hi), keeping the gap between the last probe that
    passes and the first that fails."""
    m = g.shape[0]
    lo = torch.clamp(d - num, min=0)
    hi = torch.clamp(d, max=m)
    lanes = torch.arange(1, 33)
    while bool((lo < hi).any()):
        live = lo < hi
        step = (hi - lo + 31) // 32
        p = lo[:, None] + lanes * step[:, None] - 1
        before = (p < hi[:, None]) & (g[p.clamp(0, m - 1)] < d[:, None])
        c = before.sum(1)
        lo, hi = (torch.where(live, lo + c * step, lo),
                  torch.where(live, torch.minimum(hi, lo + (c + 1) * step - 1),
                              hi))
    return lo


def merge_path_parents(s, n_in, num=None):
    """The rank step as kernels 3 and 4 compute it (csrc/rank.cuh),
    modelled in torch, one row a CTA: the split of S at its tile's two
    diagonals (the 32-way warp search); its slots [b0, b0 + nb), held in a
    buffer of ``RANK_SLOTS`` marks from ``base``, b0 rounded down to
    ``RANK_ITEMS``; the last entry of each run of equal S in its window
    marking its slot with its count within the window; and the running
    maximum of the marks, which the kernel takes within each thread's group
    and then across groups (the same integers). Raises unless the tiles'
    slots cover [0, num) once, fit their buffers and every mark has one
    writer; returns parents (num,) int32, which must equal
    ``grid_rank_plain``."""
    num = s.shape[0] if num is None else num
    m = s.shape[0]
    _, items, blocks = rank_layout(num, m)
    g = s.long() + torch.arange(m)
    d0 = torch.arange(blocks) * RANK_TILE
    d1 = torch.clamp(d0 + RANK_TILE, max=num + m)
    a0, a1 = _warp_split(g, num, d0), _warp_split(g, num, d1)
    b0, b1 = d0 - a0, d1 - a1
    base = b0 - b0 % items
    if not (bool((b0[1:] == b1[:-1]).all()) and int(b0[0]) == 0
            and int(b1[-1]) == num and bool((b1 - base <= RANK_SLOTS).all())):
        raise AssertionError("merge path: the tiles' slots do not cover "
                             "[0, num) once within their buffers")
    marks = torch.zeros(blocks, RANK_SLOTS, dtype=torch.long)
    x = torch.arange(RANK_SLOTS)
    if m:
        na, nb = (a1 - a0)[:, None], (b1 - b0)[:, None]
        j = (a0[:, None] + x).clamp(max=m - 1)
        v = s.long()[j]
        nxt = s.long()[(j + 1).clamp(max=m - 1)]
        ends = (x < na) & ((x + 1 == na) | (nxt != v)) & (v - b0[:, None] < nb)
        rows, cols = ends.nonzero(as_tuple=True)
        slot = (v - base[:, None])[rows, cols]
        if torch.unique(rows * RANK_SLOTS + slot).numel() != slot.numel():
            raise AssertionError("merge path: two run ends mark one slot")
        marks[rows, slot] = cols + 1
    ranks = torch.cummax(marks, 1).values
    parents = torch.clamp(a0[:, None] + ranks, 0, n_in - 1)
    y = x - (b0 - base)[:, None]
    mine = (y >= 0) & (y < (b1 - b0)[:, None])
    out = torch.empty(num, dtype=torch.int32)
    out[(base[:, None] + x)[mine]] = parents[mine].to(torch.int32)
    return out


def grid_rank(s, n_in, num=None):
    if s.device.type == "cpu":
        return grid_rank_plain(s, n_in, num)
    name = "grid_rank"
    num = s.shape[0] if num is None else num
    if not (s.is_cuda and s.dtype == torch.int32 and s.ndim == 1
            and s.is_contiguous()):
        raise ValueError(f"{name}: the CUDA kernel needs s as a contiguous "
                         f"1-D int32 CUDA tensor, got {s.dtype} "
                         f"{tuple(s.shape)} on {s.device}")
    if not (0 < num < 2 ** 31 and 0 < n_in < 2 ** 31 and s.shape[0] < 2 ** 31):
        raise ValueError(f"{name}: the CUDA kernel needs 0 < num, n_in < "
                         f"2^31, got num={num}, n_in={n_in}")
    parents = torch.empty(num, dtype=torch.int32, device=s.device)
    fn = _build.entry("modppl_grid_rank_i32", _ARGS)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(s.data_ptr(), s.shape[0], num, n_in, parents.data_ptr(),
                 stream)
    _build.check(err, name)
    grid_rank.launches += 1
    return parents


grid_rank.launches = 0


def systematic_parents(key, log_normalized_weights, num=None, u=None):
    """Systematic (stratified, single-uniform) ancestors: the positions
    (u + i) / num against the normalized weight CDF, S, then
    ``grid_rank``. ``u`` replaces the uniform drawn from ``key``."""
    lw = log_normalized_weights
    num = lw.shape[0] if num is None else num
    if u is None:
        u = uniform(key, lw)
    s = slot_positions(normalized_cdf(lw), u, num)
    return grid_rank(s, lw.shape[0], num)
