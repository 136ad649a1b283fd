"""Exact inference for linear-Gaussian SSMs: Kalman filtering and
smoothing, sequential and time-parallel (counterpart of
modppl_tpu/inference/kalman.py).

The sequential forms loop over time on the host, one small-matrix step a
time point. The time-parallel forms (Särkkä & García-Fernández, IEEE TAC
2021) recast filtering and smoothing as prefix compositions under an
associative operator and run them in O(log T) rounds of batched (T, D, D)
algebra. The reference calls ``jax.lax.associative_scan``; PyTorch has no
public counterpart, so :func:`associative_scan` here is the same recursive
odd-even scheme written in torch ops (the same pairs combined in the same
order). Small dimensions go through ops/smalllinalg.py's unrolled solves.

Conventions (models/lgssm.py): x_1 ~ N(mu0, P0); x_t = A x_{t-1} + N(0, Q);
y_t = H x_t + N(0, R); ys has shape (T, E). Every entry point runs on
``device``: the card unless the caller passes ``device="cpu"``; the
parameters and observations are moved there.
"""

import math

import torch

from modppl_tpu_torch.modeling.handlers import entry_device
from modppl_tpu_torch.models.lgssm import LGSSMParams
from modppl_tpu_torch.ops.smalllinalg import (
    SMALL_DIM_MAX,
    cholesky_small,
    lu_solve_small,
    solve_lower_small,
    solve_psd_small,
    tril_logdet_small,
)

# above this the unrolled pivoted LU stops paying; torch.linalg.solve wins
_LU_DIM_MAX = 8


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _solve_psd(S, B):
    """Solve S X = B for symmetric-PD S (batched): unrolled at small
    dimensions (no factorization status read back), a Cholesky above."""
    if S.shape[-1] <= SMALL_DIM_MAX:
        return solve_psd_small(S, B)
    L = torch.linalg.cholesky_ex(S).L
    if B.ndim == S.ndim - 1:
        return torch.cholesky_solve(B[..., None], L)[..., 0]
    return torch.cholesky_solve(B, L)


def _solve_general(A, B):
    """Solve general A X = B; unrolled pivoted LU at small dimensions."""
    if A.shape[-1] <= _LU_DIM_MAX:
        return lu_solve_small(A, B)
    return torch.linalg.solve(A, B)


def _mvn_logpdf(x, mean, cov):
    d = x.shape[-1]
    if d <= SMALL_DIM_MAX:
        L = cholesky_small(cov)
        z = solve_lower_small(L, x - mean)
        logdet = 2.0 * tril_logdet_small(L)
    else:
        L = torch.linalg.cholesky_ex(cov).L
        z = torch.linalg.solve_triangular(L, (x - mean)[..., None],
                                          upper=False)[..., 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(
            L, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (d * math.log(2.0 * math.pi) + logdet
                   + torch.sum(z * z, dim=-1))


def _on_device(params, ys, device, what):
    device = entry_device(device, what)
    return (LGSSMParams(*(torch.as_tensor(x).to(device) for x in (
        params.A, params.Q, params.H, params.R, params.mu0, params.P0))),
        torch.as_tensor(ys).to(device))


# --------------------------------------------------------------------------
# Sequential filter / smoother (one host step a time point)
# --------------------------------------------------------------------------

def kalman_filter(params, ys, device=None):
    """Sequential Kalman filter.

    Returns a dict of the filtered means (T, D), covariances (T, D, D),
    ``log_ml`` (the exact log marginal likelihood, sum_t log p(y_t |
    y_{1:t-1})) and ``step_log_liks`` (T,).
    """
    params, ys = _on_device(params, ys, device, "kalman_filter")
    return _filter(params, ys)


def _filter(params, ys):
    A, Q, H, R = params.A, params.Q, params.H, params.R
    m_pred, P_pred = params.mu0, params.P0
    ms, Ps, lls = [], [], []
    for y in ys:
        S = _sym(H @ P_pred @ H.T + R)
        lls.append(_mvn_logpdf(y, H @ m_pred, S))
        K = _solve_psd(S, H @ P_pred).T                   # P H^T S^-1
        m = m_pred + K @ (y - H @ m_pred)
        P = _sym(P_pred - K @ S @ K.T)
        ms.append(m)
        Ps.append(P)
        m_pred, P_pred = A @ m, _sym(A @ P @ A.T + Q)
    lls = torch.stack(lls)
    return {"means": torch.stack(ms), "covs": torch.stack(Ps),
            "log_ml": torch.sum(lls), "step_log_liks": lls}


def kalman_smoother(params, ys, device=None):
    """Sequential RTS smoother: smoothed means and covariances, plus the
    filter's outputs under ``filtered_*``."""
    params, ys = _on_device(params, ys, device, "kalman_smoother")
    A, Q = params.A, params.Q
    filt = _filter(params, ys)
    ms, Ps = filt["means"], filt["covs"]
    m_s, P_s = ms[-1], Ps[-1]
    out_m, out_P = [m_s], [P_s]
    for t in range(ys.shape[0] - 2, -1, -1):
        m, P = ms[t], Ps[t]
        P_pred = _sym(A @ P @ A.T + Q)
        G = _solve_psd(P_pred, A @ P).T                   # P A^T P_pred^-1
        m_s = m + G @ (m_s - A @ m)
        P_s = _sym(P + G @ (P_s - P_pred) @ G.T)
        out_m.append(m_s)
        out_P.append(P_s)
    return {"means": torch.stack(out_m[::-1]),
            "covs": torch.stack(out_P[::-1]),
            **{f"filtered_{k}": v for k, v in filt.items()}}


# --------------------------------------------------------------------------
# The associative scan (O(log T) rounds over the leading axis)
# --------------------------------------------------------------------------

def _interleave(a, b):
    """[a0, b0, a1, b1, ...] along the leading axis (len(a) - len(b) is 0
    or 1)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]))
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems, reverse=False):
    """Inclusive prefix compositions of the tuple of tensors ``elems``
    along their leading axis under the associative ``fn(earlier, later)``:
    ``jax.lax.associative_scan``'s recursive odd-even scheme, the same pairs
    combined in the same order. ``reverse=True`` scans from the end (the
    first operand of ``fn`` is then the later-time composite)."""
    if reverse:
        elems = tuple(torch.flip(e, (0,)) for e in elems)

    def scan(elems):
        n = elems[0].shape[0]
        if n < 2:
            return elems
        # combine adjacent pairs, scan the half, then fill in the evens
        odd = scan(fn(tuple(e[0:n - 1:2] for e in elems),
                      tuple(e[1::2] for e in elems)))
        first = tuple(o[:-1] for o in odd) if n % 2 == 0 else odd
        even = fn(first, tuple(e[2::2] for e in elems))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(tuple(elems))
    if reverse:
        out = tuple(torch.flip(e, (0,)) for e in out)
    return out


# --------------------------------------------------------------------------
# Time-parallel filter
# --------------------------------------------------------------------------

def _filter_elements(params, ys):
    """Per-step conditional-Gaussian elements (A_k, b_k, C_k, eta_k, J_k),
    each with a leading time axis. Element k parameterizes p(x_k | y_{1:k},
    x_{k-1}); their prefix compositions are the filtering distributions
    (Särkkä & García-Fernández 2021, Lemmas 7-8)."""
    A, Q, H, R = params.A, params.Q, params.H, params.R
    T, D = ys.shape[0], A.shape[-1]
    I = torch.eye(D, dtype=A.dtype, device=A.device)

    # generic step k >= 2: the predictive covariance given x_{k-1} is Q
    S = _sym(H @ Q @ H.T + R)
    K = _solve_psd(S, H @ Q).T                            # Q H^T S^-1
    HtSinv = _solve_psd(S, H).T                           # H^T S^-1
    As = ((I - K @ H) @ A).expand(T, D, D).clone()
    bs = ys @ K.T
    Cs = _sym((I - K @ H) @ Q).expand(T, D, D).clone()
    etas = (ys @ HtSinv.T) @ A
    Js = _sym(A.T @ HtSinv @ H @ A).expand(T, D, D).clone()

    # first element: the prior N(mu0, P0) conditioned on y_1 (no x_0)
    S1 = _sym(H @ params.P0 @ H.T + R)
    K1 = _solve_psd(S1, H @ params.P0).T
    As[0] = 0.0
    bs[0] = params.mu0 + K1 @ (ys[0] - H @ params.mu0)
    Cs[0] = _sym(params.P0 - K1 @ S1 @ K1.T)
    etas[0] = 0.0
    Js[0] = 0.0
    return As, bs, Cs, etas, Js


def _filter_combine(elem_i, elem_j):
    """Associative composition of filtering elements (i earlier, j later),
    batched over the leading axis."""
    Ai, bi, Ci, etai, Ji = elem_i
    Aj, bj, Cj, etaj, Jj = elem_j
    I = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    # M = (I + C_i J_j)^{-1}
    CJ = I + Ci @ Jj
    AjM = _solve_general(CJ.transpose(-1, -2),
                         Aj.transpose(-1, -2)).transpose(-1, -2)  # A_j M
    JC = I + Jj @ Ci
    AiTN = _solve_general(JC.transpose(-1, -2), Ai).transpose(-1, -2)
    A_out = AjM @ Ai
    b_out = (AjM @ (bi[..., None] + Ci @ etaj[..., None]))[..., 0] + bj
    C_out = _sym(AjM @ Ci @ Aj.transpose(-1, -2) + Cj)
    eta_out = (AiTN @ (etaj[..., None] - Jj @ bi[..., None]))[..., 0] + etai
    J_out = _sym(AiTN @ Jj @ Ai + Ji)
    return A_out, b_out, C_out, eta_out, J_out


def kalman_filter_parallel(params, ys, device=None):
    """Time-parallel Kalman filter: ~2 log2(T) rounds of batched (T, D, D)
    algebra in place of T host steps. Matches :func:`kalman_filter` to
    rounding, ``log_ml`` included."""
    params, ys = _on_device(params, ys, device, "kalman_filter_parallel")
    return _filter_parallel(params, ys)


def _filter_parallel(params, ys):
    _, ms, Ps, _, _ = associative_scan(_filter_combine,
                                       _filter_elements(params, ys))
    # the log-ML from the one-step predictives, after the scan: t = 1 uses
    # the prior, t >= 2 the filtered (m_{t-1}, P_{t-1})
    A, Q, H, R = params.A, params.Q, params.H, params.R
    m_pred = torch.cat([params.mu0[None], ms[:-1] @ A.T])
    P_pred = torch.cat([params.P0[None], _sym(A @ Ps[:-1] @ A.T + Q)])
    S = _sym(torch.einsum("ij,tjk,lk->til", H, P_pred, H) + R)
    lls = _mvn_logpdf(ys, m_pred @ H.T, S)
    return {"means": ms, "covs": Ps, "log_ml": torch.sum(lls),
            "step_log_liks": lls}


# --------------------------------------------------------------------------
# Time-parallel smoother (reverse associative scan)
# --------------------------------------------------------------------------

def _smoother_elements(params, ms, Ps):
    """Per-step smoothing elements (E_k, g_k, L_k) from filtered moments."""
    A, Q = params.A, params.Q
    P_pred = _sym(A @ Ps @ A.T + Q)
    Es = _solve_psd(P_pred, A @ Ps).transpose(-1, -2)     # P A^T P_pred^-1
    gs = ms - (Es @ (ms @ A.T)[..., None])[..., 0]
    Ls = _sym(Ps - Es @ P_pred @ Es.transpose(-1, -2))
    # the last element carries the filtered marginal itself
    Es[-1] = 0.0
    gs[-1] = ms[-1]
    Ls[-1] = Ps[-1]
    return Es, gs, Ls


def _smoother_combine(later, earlier):
    """Affine-map composition f_earlier ∘ f_later, f_k(x) = E_k x + g_k.
    Under the reverse scan the first operand is the composite of later
    elements and the second the earlier element, which sits outside."""
    Ea, ga, La = later
    Eb, gb, Lb = earlier
    E_out = Eb @ Ea
    g_out = (Eb @ ga[..., None])[..., 0] + gb
    L_out = _sym(Eb @ La @ Eb.transpose(-1, -2) + Lb)
    return E_out, g_out, L_out


def kalman_smoother_parallel(params, ys, device=None):
    """Time-parallel RTS smoother: the parallel filter, then a reverse
    associative scan."""
    params, ys = _on_device(params, ys, device, "kalman_smoother_parallel")
    filt = _filter_parallel(params, ys)
    _, gs, Ls = associative_scan(
        _smoother_combine,
        _smoother_elements(params, filt["means"], filt["covs"]),
        reverse=True)
    return {"means": gs, "covs": Ls,
            **{f"filtered_{k}": v for k, v in filt.items()}}
