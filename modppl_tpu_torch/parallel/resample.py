"""Resampling schemes and gathers (counterpart of
modppl_tpu/parallel/resample.py).

Every scheme maps ``(key, log_normalized_weights, num=None)`` to ``num``
int32 ancestors through the same O(N) grid inverse as the reference:
first-child slot positions S, one integer scatter-add, one cumsum. Each also
takes its random numbers injected (``u`` or ``us``) so that tests can feed
the reference's. The CDFs add in the reference's CPU order on a CPU tensor
(``utils/numerics.ordered_cumsum``).

The dispatch mirrors the reference's, with "on TPU" read as "on a CUDA
tensor":
- ``systematic_parents`` computes S and hands it to ``grid_rank`` (kernel 4:
  the kernel on a CUDA tensor, its plain version on a CPU one);
- ``fused_systematic_resample_or_none`` and ``fused_gather_from_s_or_none``
  take the fused ancestor + state copy (kernel 3) when the state is
  fusable: every leaf float32 on a CUDA device, at most MAX_STATE_DIM
  columns in all. Otherwise they return None and the caller gathers with
  ``gather_particles``.
The other three schemes are plain torch, as the reference computes them in
XLA outside any kernel: their integer stage is the reference's scatter-add +
cumsum, ``grid_rank_plain``, which takes an S that need not be sorted.

``blocked_resample`` resamples C independent chains of N particles each,
laid out as C consecutive blocks of one (C N,) particle axis, in one pass:
each chain's S from its own row of weights, offset by c N and flattened, so
that one launch of kernel 3 (or kernel 4) ranks every chain at once and
each slot's ancestor falls in its own block (``blocked_positions``).
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.ops.fused_resample import (
    resample_fused_from_s,
    systematic_resample_fused,
)
from modppl_tpu_torch.ops.resample import (
    grid_rank,
    grid_rank_plain,
    int_cummax,
    slot_positions,
    systematic_parents,
    uniform,
)
from modppl_tpu_torch.utils.numerics import normalized_cdf, ordered_cumsum

# the fused kernel's widest state (fused_resample_pallas.py:MAX_STATE_DIM)
MAX_STATE_DIM = 31


def multinomial_parents(key, log_normalized_weights, num=None, us=None):
    """IID categorical ancestors by sorted-uniform inversion: ``num``
    uniforms (``us``, else drawn from ``key``) sorted, each cdf_j located
    among them, then the scatter + cumsum inverse. Ancestors come out
    sorted."""
    lw = log_normalized_weights
    n_in = lw.shape[0]
    n = n_in if num is None else num
    cdf = normalized_cdf(lw)
    if us is None:
        us = uniform(key, lw, (n,))
    us = torch.sort(us).values
    s = torch.searchsorted(us, cdf, right=False).to(torch.int32)
    return grid_rank_plain(s, n_in, n)


def stratified_parents(key, log_normalized_weights, num=None, us=None):
    """Stratified ancestors: one uniform per output stratum, positions
    (i + u_i) / num."""
    lw = log_normalized_weights
    n_in = lw.shape[0]
    n = n_in if num is None else num
    cdf = normalized_cdf(lw)
    if us is None:
        us = uniform(key, lw, (n,))
    positions = (torch.arange(n, dtype=cdf.dtype, device=cdf.device) + us) / n
    s = torch.searchsorted(positions, cdf, right=False).to(torch.int32)
    return grid_rank_plain(s, n_in, n)


def _pairwise_sum(x):
    """Sum along the last axis by adjacent pairs, zero-padded to a power
    of two: a fixed order of elementwise adds, so a row sums to the same
    bits alone or in a batch, on any device and thread count."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros(tuple(x.shape[:-1]) + (p - n,))], -1)
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x


def _residual_rows(lw, u, n):
    """Residual-systematic parents of each row of ``lw`` (..., n_in) with
    its uniform ``u`` (...,): every op is row-local and sums in a fixed
    order, so a row's parents are the same alone or among others and a NaN
    row moves no other."""
    n_in = lw.shape[-1]
    w = torch.exp(lw)
    w = w / _pairwise_sum(w)
    counts = torch.floor(n * w).to(torch.int32)
    num_det = torch.sum(counts, -1, keepdim=True)
    det_parents = grid_rank_plain(ordered_cumsum(counts), n_in, n)
    resid = n * w - counts
    r_total = n - num_det.to(w.dtype)
    resid_cdf = ordered_cumsum(resid)
    resid_cdf = resid_cdf / resid_cdf[..., -1:]
    # no residual mass (N w all integers) makes resid_cdf 0/0: the int
    # clamp sends its NaN to slot 0, as XLA's conversion does
    s_res = torch.clamp(torch.clamp(torch.ceil(resid_cdf * r_total
                                               - u[..., None]), 0, n)
                        .to(torch.int32), 0, n)
    res_rank = grid_rank_plain(s_res, n_in, n)
    idx = torch.arange(n, dtype=torch.int64, device=lw.device)
    shifted = torch.gather(res_rank, -1, torch.clamp(
        idx - num_det, 0, n - 1).expand(res_rank.shape))
    return torch.where(idx >= num_det, shifted, det_parents)


def residual_parents(key, log_normalized_weights, num=None, u=None):
    """Residual-systematic resampling: floor(N w) deterministic copies, then
    a systematic sweep of the R = N - sum(floor) remaining slots over the
    residual weights, stitched with a shifted gather."""
    lw = log_normalized_weights
    n = lw.shape[0] if num is None else num
    if u is None:
        u = uniform(key, lw)
    return _residual_rows(lw, torch.as_tensor(u, dtype=lw.dtype,
                                              device=lw.device), n)


RESAMPLERS = {
    "multinomial": multinomial_parents,
    "systematic": systematic_parents,
    "stratified": stratified_parents,
    "residual": residual_parents,
}


def gather_particles(tree, parents):
    """tree[i] = tree[parents[i]] on every leaf's leading axis."""
    idx = parents.long()
    return pytree.tree_map(lambda x: torch.index_select(x, 0, idx), tree)


def _fusable(n, tree):
    """The state's leaves if the fused kernel takes them (every leaf a
    float32 CUDA tensor with leading axis n, at most MAX_STATE_DIM columns
    in all), else None."""
    leaves, spec = pytree.tree_flatten(tree)
    if not leaves:
        return None
    width = 0
    for leaf in leaves:
        if not (torch.is_tensor(leaf) and leaf.is_cuda
                and leaf.dtype == torch.float32 and leaf.ndim >= 1
                and leaf.shape[0] == n):
            return None
        width += leaf[0].numel()
    if width > MAX_STATE_DIM:
        return None
    return leaves, spec


def _as_block(leaves, n):
    """The leaves' trailing axes flattened into the columns of one (N, C)
    block, so a single launch serves the whole state."""
    cols = [leaf.reshape(n, -1) for leaf in leaves]
    return (cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)).contiguous()


def _from_block(block, leaves, spec):
    out, off = [], 0
    for leaf in leaves:
        k = leaf[0].numel()
        out.append(block[:, off:off + k].reshape(leaf.shape))
        off += k
    return pytree.tree_unflatten(out, spec)


def gather_from_s(s, tree):
    """Ancestors from the sorted slot positions ``s`` and every leaf of the
    particle-state pytree ``tree`` (leading axis N) copied from its
    ancestor, through kernel 3 (which raises on a CUDA state it does not
    take). Returns ``(new_tree, parents)``."""
    n = s.shape[0]
    leaves, spec = pytree.tree_flatten(tree)
    new_block, parents = resample_fused_from_s(s, _as_block(leaves, n),
                                               layout="nc")
    return _from_block(new_block, leaves, spec), parents


def fused_gather_from_s_or_none(s, tree):
    """``gather_from_s`` when the state is fusable, else None."""
    if _fusable(s.shape[0], tree) is None:
        return None
    return gather_from_s(s, tree)


def fused_systematic_resample_or_none(key, log_normalized_weights, tree,
                                      u=None):
    """Systematic resampling through the fused kernel (S from the weights,
    then kernel 3) when the state is fusable: ``(new_tree, parents)``,
    parents equal to ``systematic_parents``' on the same uniform. Else
    None, and the caller takes ``systematic_parents`` and
    ``gather_particles``."""
    n = log_normalized_weights.shape[0]
    fus = _fusable(n, tree)
    if fus is None:
        return None
    leaves, spec = fus
    new_block, parents = systematic_resample_fused(
        key, log_normalized_weights, _as_block(leaves, n), layout="nc", u=u)
    return _from_block(new_block, leaves, spec), parents


# --------------------------------------------------------------------------
# Chain-blocked resampling: C chains of N particles on one particle axis
# --------------------------------------------------------------------------

BLOCKED_SCHEMES = ("systematic", "multinomial", "stratified", "residual")


def blocked_positions(s_rows):
    """Each chain's slot positions (C, N), made safe and offset onto the
    shared axis: clamped to [0, N], an integer cummax, the last set to N
    (a chain with finite weights has it already, as its CDF ends at 1),
    then + c N, flattened to (C N,) int32. The offsets are sorted whatever
    one chain's weights hold (a NaN row gives garbage S_c, which stays in
    [c N, (c + 1) N]), so the rank of every slot of chain c counts all of
    the chains before it and none after it: its ancestor lies in its own
    block, and no chain's S moves another's ancestors."""
    c, n = s_rows.shape
    s = int_cummax(torch.clamp(s_rows, 0, n))
    s = torch.cat([s[:, :-1], s.new_full((c, 1), n)], dim=1)
    offsets = torch.arange(c, dtype=torch.int32, device=s.device) * n
    return (s + offsets[:, None]).reshape(-1)


def blocked_resample(scheme, log_norm, tree, u):
    """Resample C chains at once: ``log_norm`` (C, N) each chain's
    normalized log-weights, ``tree`` the particle state (leading axis
    C N), ``u`` the uniforms ((C,) for systematic and residual, (C, N) for
    multinomial and stratified). Systematic S goes to kernel 3 with the
    state when it is fusable (one launch for every chain), else to kernel
    4; multinomial and stratified rank by ``grid_rank_plain``, as their
    one-chain forms do. Residual runs each chain's deterministic copies and
    residual sweep inside its own row (``_residual_rows``: chain c's
    parents are ``residual_parents`` of its weights and uniform, + c N).
    Returns (new tree, parents (C N,) int32 on the shared axis)."""
    c, n = log_norm.shape
    if scheme == "systematic":
        cdf = normalized_cdf(log_norm)
        s = blocked_positions(slot_positions(cdf, u[:, None], n))
        fused = fused_gather_from_s_or_none(s, tree)
        if fused is not None:
            return fused
        parents = grid_rank(s, c * n)
    elif scheme in ("multinomial", "stratified"):
        cdf = normalized_cdf(log_norm)
        if scheme == "multinomial":
            positions = torch.sort(u, dim=1).values
        else:
            positions = (torch.arange(n, dtype=cdf.dtype, device=cdf.device)
                         + u) / n
        s = torch.searchsorted(positions.contiguous(), cdf.contiguous(),
                               right=False).to(torch.int32)
        parents = grid_rank_plain(blocked_positions(s), c * n)
    elif scheme == "residual":
        offsets = torch.arange(c, dtype=torch.int32,
                               device=log_norm.device) * n
        parents = (_residual_rows(log_norm, u, n)
                   + offsets[:, None]).reshape(-1)
    else:
        raise ValueError(f"chain-blocked resampling: expected one of "
                         f"{BLOCKED_SCHEMES}, got {scheme!r}")
    return gather_particles(tree, parents), parents
