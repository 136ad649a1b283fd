"""Multivariate normal (counterpart of modppl_tpu/dists/mvnormal.py).

Up to ``SMALL_DIM_MAX`` = 32 dimensions the factorization is the
closed-form unrolled Cholesky-Banachiewicz of modppl_tpu/ops/smalllinalg.py,
written out per entry. On CUDA that keeps the factor on the device:
``torch.linalg.cholesky`` goes through cuSOLVER and checks its ``info`` on
the host, a sync per call. Above 32 the unrolled form costs O(k^3) tensor
ops per logpdf, so the factor comes from ``torch.linalg.cholesky_ex`` (no
host check) and the solve from ``torch.linalg.solve_triangular``, as the
reference does with ``jnp.linalg`` above the same bound.

A covariance given as a constant (a nested sequence of numbers, like the
spiral's ``OBS_COV``) is factored once on the host, cached, and its entries
enter the arithmetic as host scalars broadcast over every particle. It is
never expanded to (N, k, k).
"""

import math
from functools import lru_cache

import torch

from modppl_tpu_torch.dists.base import Distribution

SMALL_DIM_MAX = 32


def _sqrt(v):
    if torch.is_tensor(v):
        return torch.sqrt(v)
    return math.sqrt(v) if v >= 0 else math.nan


def _log_abs(v):
    return torch.log(torch.abs(v)) if torch.is_tensor(v) else math.log(abs(v))


def _cholesky_entries(a, k):
    """Lower factor as a nested list L[i][j] (j <= i) of ``a(i, j)`` terms:
    L[i][j] = (a[i,j] - sum_{m<j} L[i][m] L[j][m]) / L[j][j], and the square
    root on the diagonal (smalllinalg.cholesky_small's order)."""
    L = [[0.0] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = a(i, j)
            for m in range(j):
                s = s - L[i][m] * L[j][m]
            L[i][j] = _sqrt(s) if i == j else s / L[j][j]
    return L


@lru_cache(maxsize=256)
def _constant_cholesky(cov):
    return _cholesky_entries(lambda i, j: float(cov[i][j]), len(cov))


def cholesky(cov):
    """The lower factor of ``cov`` as nested entries: host floats for a
    constant covariance, tensors (broadcasting over batch axes) otherwise."""
    if torch.is_tensor(cov):
        return _cholesky_entries(lambda i, j: cov[..., i, j], cov.shape[-1])
    return _constant_cholesky(tuple(tuple(float(v) for v in row)
                                    for row in cov))


class MvNormal(Distribution):
    """Multivariate Gaussian over vectors; params (mean vector, covariance).
    A draw is mu + L z for standard normals z (``_from_standard``, the lane
    form)."""

    event_rank = 1
    standard = "normal"

    def batched(self, params):
        mu, cov = params
        return ((torch.is_tensor(mu) and mu.ndim > 1)
                or (torch.is_tensor(cov) and cov.ndim > 2))

    def _lane_shape(self, params):
        mu, cov = params
        batch = torch.broadcast_shapes(
            tuple(mu.shape[:-1]) if torch.is_tensor(mu) else (),
            tuple(cov.shape[:-2]) if torch.is_tensor(cov) else ())
        return tuple(batch) + (_dim(mu, cov),)

    def _from_standard(self, z, mu, cov):
        if _dim(mu, cov) > SMALL_DIM_MAX:
            L = torch.linalg.cholesky_ex(_as_tensor(cov, z)).L
            return mu + (L @ z[..., None])[..., 0]
        L = cholesky(cov)
        rows = []
        for i in range(len(L)):
            acc = L[i][0] * z[..., 0]
            for j in range(1, i + 1):
                acc = acc + L[i][j] * z[..., j]
            rows.append(acc)
        return mu + torch.stack(rows, dim=-1)

    def _logpdf(self, x, mu, cov):
        if _dim(mu, cov) > SMALL_DIM_MAX:
            return _logpdf_large(x, mu, cov)
        L = cholesky(cov)
        k = len(L)
        b = x - mu
        # forward substitution L z = (x - mu), smalllinalg.solve_lower_small
        z = []
        for i in range(k):
            s = b[..., i]
            for m in range(i):
                s = s - L[i][m] * z[m]
            z.append(s / L[i][i])
        logdet = _log_abs(L[0][0])
        for i in range(1, k):
            logdet = logdet + _log_abs(L[i][i])
        logdet = 2.0 * logdet
        maha = z[0] * z[0]
        for i in range(1, k):
            maha = maha + z[i] * z[i]
        return -(k * math.log(2.0 * math.pi) + logdet + maha) / 2.0

    def _sample(self, gen, shape, dtype, mu, cov):
        shape = torch.broadcast_shapes(shape + (_dim(mu, cov),),
                                       tuple(mu.shape))
        z = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
        return self._from_standard(z, mu, cov)


def _dim(mu, cov):
    return mu.shape[-1] if torch.is_tensor(mu) else len(cov)


def _as_tensor(cov, like):
    if torch.is_tensor(cov):
        return cov
    return torch.tensor(cov, dtype=like.dtype, device=like.device)


def _logpdf_large(x, mu, cov):
    """The k > SMALL_DIM_MAX arm: one batched factor and triangular solve."""
    L = torch.linalg.cholesky_ex(_as_tensor(cov, x)).L
    k = L.shape[-1]
    r = torch.broadcast_to(x - mu, torch.broadcast_shapes(
        (x - mu).shape, L.shape[:-1]))
    z = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                             dim=-1)
    maha = torch.sum(z * z, dim=-1)
    return -(k * math.log(2.0 * math.pi) + logdet + maha) / 2.0


mvnormal = MvNormal()
