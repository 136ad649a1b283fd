"""Correlated, ill-conditioned Gaussian target (counterpart of
modppl_tpu/models/illcond_gauss.py).

One d-dimensional ``mvnormal`` latent "x" ~ N(0, Σ), Σ with log-spaced
eigenvalues spanning ``cond`` mixed by a fixed random rotation: every
coordinate couples every eigendirection, and the unconstrained
log-density is quadratic (Λ = Σ⁻¹), so at d >= 13 the d >= 13 HMC chunk
kernels run it.
"""

import numpy as np
import torch

from modppl_tpu_torch.dists import mvnormal
from modppl_tpu_torch.modeling import gen


def illcond_cov(d, cond=1e4, seed=0, dtype=np.float32):
    """Σ = Q diag(λ) Qᵀ with λ log-spaced in [1/cond, 1] and Q a fixed
    random orthogonal matrix (deterministic in ``seed``), as numpy."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.logspace(-np.log10(cond), 0.0, d)
    cov = (q * lam) @ q.T
    cov = 0.5 * (cov + cov.T)  # exact symmetry for Cholesky
    return np.asarray(cov, dtype)


def make_illcond_gauss(d, cond=1e4, seed=0):
    """Model with one latent address "x" ~ N(0, Σ_illcond), no arguments:
    call it with ``device=``. Σ is float32, as in the reference."""
    cov = torch.from_numpy(illcond_cov(d, cond, seed))
    on_device = {}

    @gen
    def illcond_gauss(h):
        if h.device not in on_device:
            c = cov.to(h.device)
            on_device[h.device] = (torch.zeros(d, dtype=c.dtype,
                                               device=h.device), c)
        return h.sample(mvnormal, on_device[h.device], "x")

    return illcond_gauss
