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

A draw whose covariance is not positive definite takes the reference's
fallback factor, ``v sqrt(clip(w, 0))`` of ``eigh`` (``factor``), where
the Cholesky factor has a NaN (below 33 dimensions; above, where
``cholesky_ex`` reports a failure). The reference decides it on eager
calls, reading the factor from its device, and not under its transforms,
where the factor is traced; the port decides it alike outside
``torch.func`` transforms, and keeps the Cholesky factor inside them (a
NaN there propagates, as in the reference's compiled calls). The decision
is read once per covariance: a constant on the host, a tensor once per
tensor and version (``_fails``), so a model's fixed covariance on the card
costs one device read a process, not one a draw.
"""

import math
import weakref
from functools import lru_cache

import torch

from modppl_tpu_torch.dists.base import Distribution

SMALL_DIM_MAX = 32


def _sqrt(v):
    if torch.is_tensor(v):
        return torch.sqrt(v)
    return math.sqrt(v) if v >= 0 else math.nan


def _div(a, b):
    """a / b, with IEEE's answers for host numbers at b = 0."""
    if torch.is_tensor(a) or torch.is_tensor(b) or b != 0:
        return a / b
    if a == 0 or math.isnan(a):
        return math.nan
    return math.copysign(math.inf, a) * math.copysign(1.0, b)


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
            L[i][j] = _sqrt(s) if i == j else _div(s, L[j][j])
    return L


@lru_cache(maxsize=256)
def _constant_cholesky(cov):
    return _cholesky_entries(lambda i, j: float(cov[i][j]), len(cov))


def _as_key(cov):
    return tuple(tuple(float(v) for v in row) for row in cov)


def cholesky(cov):
    """The lower factor of ``cov`` as nested entries: host floats for a
    constant covariance, tensors (broadcasting over batch axes) otherwise."""
    if torch.is_tensor(cov):
        return _cholesky_entries(lambda i, j: cov[..., i, j], cov.shape[-1])
    return _constant_cholesky(_as_key(cov))


def eigh_factor(cov):
    """The reference's non-PD factor, ``v * sqrt(clip(w, 0))[..., None, :]``
    of ``eigh(cov)``: T with T T^T = cov."""
    w, v = torch.linalg.eigh(cov)
    return v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]


@lru_cache(maxsize=256)
def _constant_factor(cov):
    L = _constant_cholesky(cov)
    if not any(math.isnan(x) for row in L for x in row):
        return L
    T = eigh_factor(torch.tensor(cov, dtype=torch.float64))
    return [[float(x) for x in row] for row in T]


# id(cov) -> (cov._version, whether it fails): each entry dropped when its
# tensor is freed, and read again after an in-place change
_DECIDED = {}


def _fails(cov, failed):
    """Whether the tensor ``cov`` takes the fallback factor: False inside a
    ``torch.func`` transform, where it cannot be read; else ``failed()``, a
    bool tensor, read once for this tensor and version."""
    if torch._C._functorch.is_functorch_wrapped_tensor(cov):
        return False
    if cov.is_inference():  # no version counter to key the decision by
        return bool(failed())
    hit = _DECIDED.get(id(cov))
    if hit is not None and hit[0] == cov._version:
        return hit[1]
    if hit is None:
        weakref.finalize(cov, _DECIDED.pop, id(cov), None)
    out = bool(failed())
    _DECIDED[id(cov)] = (cov._version, out)
    return out


def factor(cov):
    """The factor a draw multiplies its standard normals by: the lower
    Cholesky factor, or where it fails outside a ``torch.func`` transform
    (see the module docstring) ``eigh_factor``. Nested host floats for a
    constant covariance; nested entries (Cholesky) or a (..., k, k) tensor
    otherwise."""
    if not torch.is_tensor(cov):
        return _constant_factor(_as_key(cov))
    k = cov.shape[-1]
    if k > SMALL_DIM_MAX:
        L, info = torch.linalg.cholesky_ex(cov)
        if _fails(cov, lambda: (info != 0).any()):
            return eigh_factor(cov)
        return L
    L = cholesky(cov)
    if _fails(cov, lambda: torch.isnan(torch.stack(
            [L[i][j] for i in range(k) for j in range(i + 1)])).any()):
        return eigh_factor(cov)
    return L


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
        T = factor(_as_tensor(cov, z) if _dim(mu, cov) > SMALL_DIM_MAX
                   else cov)
        if torch.is_tensor(T):
            return mu + (T.to(z.dtype) @ z[..., None])[..., 0]
        # row i of T z over the entries T holds: j <= i for a Cholesky
        # factor, every j for the fallback's
        full = _full(T)
        rows = []
        for i, row in enumerate(T):
            acc = row[0] * z[..., 0]
            for j in range(1, len(row) if full else i + 1):
                acc = acc + row[j] * z[..., j]
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


def _full(T):
    """True for a factor with entries above its diagonal (the fallback's):
    a Cholesky factor's are the host zeros of ``_cholesky_entries``."""
    return any(not (isinstance(x, float) and x == 0.0)
               for i, row in enumerate(T) for x in row[i + 1:])


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
