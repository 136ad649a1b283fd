"""Systematic-resampling ancestors from sorted slot positions: kernel 4.

Counterpart of modppl_tpu/ops/resample_pallas.py (Pallas kernel
``grid_rank``, entry ``systematic_parents_pallas``). The CUDA kernel is in
csrc/grid_rank.cu; its header says what bounds it and why it searches
instead of streaming blocks of S through vector compares.

- ``grid_rank(s, n_in, num=None)``: parents[i] = #{j : S_j <= i} for the
  ``num`` output slots (default ``s.shape[0]``), clipped to [0, n_in - 1],
  from S (M,) int32 sorted in [0, num]. On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs ``grid_rank_plain``, the
  reference's integer scatter-add + cumsum (parallel/resample.py:44-46).
  ``grid_rank.launches`` counts kernel launches.
- ``slot_positions(cdf, u, num)``: S = cummax(clip(ceil(num cdf - u), 0,
  num)), the sorted first-child slot of each particle.
- ``systematic_parents(key, lw, num=None, u=None)``: the counterpart of
  ``systematic_parents_pallas`` and of ``parallel/resample.
  systematic_parents`` (which re-exports it): the single uniform from
  ``key`` (or ``u``), the normalized CDF, S, then ``grid_rank``.
"""

import ctypes

import torch

from modppl_tpu_torch.core.keys import generator
from modppl_tpu_torch.ops import _build
from modppl_tpu_torch.utils.numerics import normalized_cdf

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _I, _I, _I, _P, _P)


def uniform(key, like, shape=()):
    """Uniforms in [0, 1) of ``like``'s dtype on its device, from the
    stream of ``key``."""
    return torch.rand(shape, generator=generator(key, like.device),
                      dtype=like.dtype, device=like.device)


_ROW = 1024
_INT32_MIN = -(2 ** 31)


def int_cummax(s):
    """Running maximum of the 1-D int32 ``s``: within rows of 1024, then
    each row raised to the maximum of the rows before it (the same integers
    as one cummax). A 1-D ``torch.cummax`` on the card scans the whole
    vector in a single block (PERF.md has both times)."""
    n = s.shape[0]
    if n <= _ROW:
        return torch.cummax(s, 0).values
    rows = -(-n // _ROW)
    if rows * _ROW != n:
        s = torch.cat([s, s.new_full((rows * _ROW - n,), _INT32_MIN)])
    inner = torch.cummax(s.reshape(rows, _ROW), 1).values
    prev = int_cummax(inner[:, -1].contiguous())
    prev = torch.cat([prev.new_full((1,), _INT32_MIN), prev[:-1]])
    return torch.maximum(inner, prev[:, None]).reshape(-1)[:n]


def slot_positions(cdf, u, num):
    """Sorted slot positions S (int32, in [0, num]) of the systematic grid
    (u + arange(num)) / num against ``cdf``. The integer cummax repairs a
    CDF that a parallel prefix sum left locally non-monotone, as the
    reference does in every systematic formulation."""
    s = torch.clamp(torch.ceil(cdf * num - u), 0, num).to(torch.int32)
    return int_cummax(s)


def grid_rank_plain(s, n_in, num=None):
    """Plain version: scatter-add of S into num + 1 bins, then a cumsum."""
    num = s.shape[0] if num is None else num
    z = torch.bincount(s.long(), minlength=num + 1)
    return torch.clamp(torch.cumsum(z[:num], 0), 0, n_in - 1).to(torch.int32)


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
