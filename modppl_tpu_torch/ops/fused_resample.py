"""Fused ancestors + state gather from sorted slot positions: kernel 3.

Counterpart of modppl_tpu/ops/fused_resample_pallas.py:resample_fused_from_s
(Pallas core ``_fused_gather``). The CUDA kernel is in
csrc/fused_resample.cu: each CTA ranks its tile of the merged slots and S
(csrc/rank.cuh, the merge path kernel 4 shares; ``ops.resample.
merge_path_parents`` models it), then copies its contiguous range of
output rows; its header says what bounds it and why it gathers instead of
contracting one-hot matrices. A GPU gather copies exactly, so none of the
reference's precision modes exist here.

``resample_fused_from_s(s, state, layout="cn")`` takes S (N,) int32 sorted
in [0, N] and the state as (C, N) (``layout="cn"``, the JAX entry's
signature) or (N, C) (``"nc"``, how the filter keeps it). It returns
``(new_state, parents)`` with parents[i] = #{j : S_j <= i} clipped to
[0, N-1] and new_state a bitwise copy of each ancestor's columns. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs the plain
version. ``resample_fused_from_s.launches`` counts kernel launches.

The kernel arm is an ``autograd.Function`` (``_FusedGather``): its forward
is the kernel, its backward the adjoint of the gather, a scatter-add of the
output's gradient into each ancestor's row (``index_add``), which is what
XLA differentiates the reference's ``take`` into. S and the parents are
integers and take no gradient. The backward is plain PyTorch, as the
reference has no backward kernel. It supports one backward pass: a second
derivative or a forward-mode derivative raises, so the kernel arm never
returns a state that has silently lost its gradient.
``systematic_resample_fused(key, lw, state_t)`` is the reference's
key-taking entry: it computes S from the weights, then calls the kernel.
"""

import ctypes

import torch

from modppl_tpu_torch.ops import _build
from modppl_tpu_torch.ops.resample import slot_positions, uniform
from modppl_tpu_torch.utils.numerics import normalized_cdf

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _P)


def parents_from_s(s, num_particles):
    """Ancestors by the exact integer scatter + cumsum inverse
    (sharded_smc._parents_from_s): parents[i] = #{j : S_j <= i}."""
    n = num_particles
    z = torch.bincount(s.long(), minlength=n + 1)
    return torch.clamp(torch.cumsum(z[:n], 0), 0, n - 1).to(torch.int32)


def _dims(s, state, layout):
    if s.ndim != 1 or state.ndim != 2 or layout not in ("cn", "nc"):
        raise ValueError(
            "resample_fused_from_s: expects s (N,) and state (C, N) "
            f"(layout 'cn') or (N, C) (layout 'nc'); got s {tuple(s.shape)}, "
            f"state {tuple(state.shape)}, layout {layout!r}")
    n = s.shape[0]
    c, n_state = state.shape if layout == "cn" else state.shape[::-1]
    if n_state != n:
        raise ValueError(f"resample_fused_from_s: state has {n_state} "
                         f"particles, s has {n}")
    return n, c


def resample_fused_plain(s, state, layout="cn"):
    """Plain version: scatter + cumsum ancestors, then an index gather."""
    n, _ = _dims(s, state, layout)
    parents = parents_from_s(s, n)
    axis = 1 if layout == "cn" else 0
    return torch.index_select(state, axis, parents.long()), parents


def resample_fused_from_s(s, state, layout="cn"):
    if s.device.type == "cpu":
        return resample_fused_plain(s, state, layout)
    _dims(s, state, layout)
    return _FusedGather.apply(s, state, layout)


class _FusedGather(torch.autograd.Function):
    """Kernel 3 with the gather's adjoint as its backward."""

    @staticmethod
    def forward(s, state, layout):
        return _launch(s, state, layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        s, state, layout = inputs
        ctx.layout = layout
        ctx.shape = state.shape
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(output[1])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_state, _grad_parents):
        (parents,) = ctx.saved_tensors
        if grad_state is None:
            return None, None, None
        axis = 1 if ctx.layout == "cn" else 0
        grad = grad_state.new_zeros(ctx.shape).index_add_(
            axis, parents.long(), grad_state)
        return None, grad, None


def _launch(s, state, layout):
    """One launch of kernel 3 into fresh outputs."""
    name = "resample_fused_from_s"
    n, c = _dims(s, state, layout)

    def require(cond, what):
        if not cond:
            raise ValueError(f"{name}: the CUDA kernel needs {what}")

    require(s.is_cuda and s.dtype == torch.int32 and s.is_contiguous(),
            f"s as a contiguous int32 CUDA tensor, got {s.dtype} on {s.device}")
    require(state.device == s.device and state.dtype == torch.float32
            and state.is_contiguous(),
            f"state as a contiguous float32 tensor on {s.device}, got "
            f"{state.dtype} on {state.device}")
    require(0 < n < 2 ** 31 and c >= 1, f"N > 0 and C >= 1, got N={n}, C={c}")
    new_state = torch.empty_like(state)
    parents = torch.empty(n, dtype=torch.int32, device=s.device)
    fn = _build.entry("modppl_resample_from_s_f32", _ARGS)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(s.data_ptr(), state.data_ptr(), new_state.data_ptr(),
                 parents.data_ptr(), n, c, int(layout == "nc"), stream)
    _build.check(err, name)
    resample_fused_from_s.launches += 1
    return new_state, parents


resample_fused_from_s.launches = 0


def systematic_resample_fused(key, log_normalized_weights, state_t,
                              layout="cn", u=None):
    """Systematic resampling with the fused ancestor + state copy
    (fused_resample_pallas.py:332-356): the single uniform from ``key`` (or
    ``u``), the normalized CDF, S = cummax(clip(ceil(N cdf - u), 0, N)),
    then ``resample_fused_from_s``. Returns ``(new_state, parents)``;
    parents equal ``ops.resample.systematic_parents_kernel``'s on the same
    uniform."""
    lw = log_normalized_weights
    if u is None:
        u = uniform(key, lw)
    s = slot_positions(normalized_cdf(lw), u, lw.shape[0])
    return resample_fused_from_s(s, state_t, layout)
