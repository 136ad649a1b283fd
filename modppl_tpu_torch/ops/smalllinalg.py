"""Linear algebra for small static dimensions, unrolled in plain torch ops
(counterpart of modppl_tpu/ops/smalllinalg.py).

No kernel lies here: the reference wrote these forms to keep XLA custom
calls out of its programs, not as Pallas. The port keeps them for two
reasons of its own: they broadcast over any leading batch axes and run
under ``torch.func`` transforms like any other arithmetic, and on the card
they never read back a factorization's status (``torch.linalg.cholesky``
checks its ``info`` on the host, a sync per call). Each function keeps the
reference's loop order, so the two agree to rounding.

All functions take the matrix dimension from the trailing shape and unroll
O(k^2)..O(k^3) scalar-slot expressions, meant for k <= ``SMALL_DIM_MAX``.
``dists/mvnormal.py`` keeps its own closed-form Cholesky (it also factors
host constants once).
"""

import torch

SMALL_DIM_MAX = 32


def cholesky_small(a):
    """Lower-Cholesky of PSD ``a`` (..., k, k) by unrolled Banachiewicz:
    L[i,j] = (a[i,j] - sum_m<j L[i,m] L[j,m]) / L[j,j], L[i,i] = sqrt(a[i,i]
    - sum L[i,m]^2). A non-PD input gives NaNs."""
    k = a.shape[-1]
    zero = torch.zeros_like(a[..., 0, 0])
    L = [[zero] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = a[..., i, j]
            for m in range(j):
                s = s - L[i][m] * L[j][m]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    return torch.stack([torch.stack(row, dim=-1) for row in L], dim=-2)


def solve_lower_small(L, b):
    """Solve L z = b by unrolled forward substitution; ``L`` (..., k, k)
    lower-triangular, ``b`` (..., k), broadcasting over batch axes."""
    k = L.shape[-1]
    z = []
    for i in range(k):
        s = b[..., i]
        for m in range(i):
            s = s - L[..., i, m] * z[m]
        z.append(s / L[..., i, i])
    return torch.stack(z, dim=-1)


def solve_upper_small(U, b):
    """Solve U z = b by unrolled backward substitution (U upper-triangular)."""
    k = U.shape[-1]
    z = [None] * k
    for i in range(k - 1, -1, -1):
        s = b[..., i]
        for m in range(i + 1, k):
            s = s - U[..., i, m] * z[m]
        z[i] = s / U[..., i, i]
    return torch.stack(z, dim=-1)


def solve_psd_small(S, B):
    """Solve S X = B for symmetric-PD ``S`` (..., k, k) through the unrolled
    Cholesky; ``B`` (..., k) or (..., k, m), column by column."""
    L = cholesky_small(S)
    Lt = L.transpose(-1, -2)
    if B.ndim == S.ndim - 1:          # vector right-hand side
        return solve_upper_small(Lt, solve_lower_small(L, B))
    cols = [solve_upper_small(Lt, solve_lower_small(L, B[..., :, j]))
            for j in range(B.shape[-1])]
    return torch.stack(cols, dim=-1)


def lu_solve_small(A, B):
    """Solve general A X = B by unrolled LU with partial pivoting; ``A``
    (..., k, k), ``B`` (..., k, m).

    Pivoting is a bubble pass of ``where``-selected row swaps (after row i
    is compared with each row j > i it holds the largest |pivot|), so the
    solve is branch-free elementwise arithmetic."""
    k = A.shape[-1]
    arows = [A[..., i, :] for i in range(k)]
    brows = [B[..., i, :] for i in range(k)]
    for i in range(k):
        for j in range(i + 1, k):
            c = (torch.abs(arows[j][..., i])
                 > torch.abs(arows[i][..., i]))[..., None]
            arows[i], arows[j] = (torch.where(c, arows[j], arows[i]),
                                  torch.where(c, arows[i], arows[j]))
            brows[i], brows[j] = (torch.where(c, brows[j], brows[i]),
                                  torch.where(c, brows[i], brows[j]))
        inv = 1.0 / arows[i][..., i]
        for j in range(i + 1, k):
            f = (arows[j][..., i] * inv)[..., None]
            arows[j] = arows[j] - f * arows[i]
            brows[j] = brows[j] - f * brows[i]
    xrows = [None] * k
    for i in range(k - 1, -1, -1):
        s = brows[i]
        for j in range(i + 1, k):
            s = s - arows[i][..., j: j + 1] * xrows[j]
        xrows[i] = s / arows[i][..., i: i + 1]
    return torch.stack(xrows, dim=-2)


def matvec_small(m, v):
    """(..., k, k) @ (..., k) as a broadcast multiply and sum."""
    return torch.sum(m * v[..., None, :], dim=-1)


def tril_logdet_small(L):
    """log |det| of a triangular factor: the sum of log |diag|."""
    k = L.shape[-1]
    acc = torch.log(torch.abs(L[..., 0, 0]))
    for i in range(1, k):
        acc = acc + torch.log(torch.abs(L[..., i, i]))
    return acc
