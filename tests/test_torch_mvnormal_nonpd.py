"""mvnormal's non-positive-definite factor (dists/mvnormal.py) against the
reference's eager one (modppl_tpu/dists/mvnormal.py:58-60,
``v * sqrt(clip(w, 0))`` of ``eigh`` where the Cholesky factor has a NaN),
on the CPU in float64: the factor and a draw on injected normals at 1e-10,
for a constant covariance (decided on the host, once) and a CPU tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.dists import mvnormal as jmvnormal
from modppl_tpu.ops.smalllinalg import matvec_small
from modppl_tpu_torch.dists import mvnormal
from modppl_tpu_torch.dists.mvnormal import factor
from _torch_threads import one_thread  # noqa: F401

F64 = torch.float64

# rank-deficient, PSD: the Cholesky of each divides 0 by 0 at a later
# entry (a NaN), so both packages take the eigendecomposition. Each has
# exactly zero eigenvalues, so the factor is unique: a null space whose
# eigenvalues round to ~1e-16 would give ~1e-8 columns of any sign
RANK_DEFICIENT = {
    "rank2_of_3": ((1.0, 1.0, 0.0), (1.0, 1.0, 0.0), (0.0, 0.0, 2.0)),
    "diagonal_with_a_zero": ((2.0, 0.0, 0.0), (0.0, 0.0, 0.0),
                             (0.0, 0.0, 1.0)),
}


def _reference(cov, z, mu):
    cov_j = jnp.asarray(np.asarray(cov))
    t = jmvnormal._transform(cov_j)
    x = jnp.asarray(np.asarray(mu)) + matvec_small(t, jnp.asarray(z))
    return np.asarray(t), np.asarray(x)


@pytest.mark.parametrize("name", list(RANK_DEFICIENT))
@pytest.mark.parametrize("form", ["constant", "cpu_tensor"])
def test_non_pd_factor_and_draw_match_reference(name, form):
    cov = RANK_DEFICIENT[name]
    rng = np.random.default_rng(3)
    z = rng.standard_normal((5, 3))
    mu = np.array([0.5, -1.0, 2.0])
    t_ref, x_ref = _reference(cov, z, mu)
    assert np.isnan(np.asarray(jmvnormal._transform.__globals__["_chol"](
        jnp.asarray(np.asarray(cov))))).any()
    c = cov if form == "constant" else torch.tensor(cov, dtype=F64)
    t = factor(c)
    t = torch.as_tensor(t, dtype=F64) if not torch.is_tensor(t) else t
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-10, atol=1e-10)
    x = mvnormal.from_standard(torch.tensor(z, dtype=F64),
                               (torch.tensor(mu, dtype=F64), c))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-10, atol=1e-10)
    # the factor reproduces the covariance
    np.testing.assert_allclose((t @ t.T).numpy(), np.asarray(cov),
                               atol=1e-12)


def test_pd_covariance_keeps_its_cholesky_factor():
    cov = ((2.0, 0.3), (0.3, 1.0))
    L = factor(cov)
    assert L[0][1] == 0.0 and L[1][1] > 0
    Lt = factor(torch.tensor(cov, dtype=F64))
    assert isinstance(Lt, list) and torch.is_tensor(Lt[1][1])
    want = np.linalg.cholesky(np.asarray(cov))
    np.testing.assert_allclose([[float(v) for v in row] for row in Lt], want,
                               rtol=1e-14, atol=1e-14)


def test_fallback_is_not_taken_on_a_batched_covariance():
    """A covariance that a torch.func transform batches cannot be checked
    without reading it, so its factor stays the Cholesky one, as the
    reference's traced calls keep theirs; the same covariance outside the
    transform takes the fallback."""
    cov = torch.tensor(RANK_DEFICIENT["rank2_of_3"], dtype=F64)
    z = torch.ones(3, dtype=F64)

    def draw(c):
        return mvnormal.from_standard(z, (torch.zeros(3, dtype=F64), c))

    assert torch.isnan(torch.func.vmap(draw)(cov.expand(2, 3, 3))).any()
    assert torch.isfinite(draw(cov)).all()


def test_large_k_cpu_tensor_takes_the_fallback():
    """Above 32 dimensions the factor is cholesky_ex's; a failed one on
    the CPU takes the eigendecomposition too."""
    rng = np.random.default_rng(0)
    b = rng.standard_normal((40, 20))
    cov = torch.tensor(b @ b.T, dtype=F64)  # rank 20 of 40
    t = factor(cov)
    assert torch.is_tensor(t) and t.shape == (40, 40)
    np.testing.assert_allclose((t @ t.T).numpy(), cov.numpy(), atol=1e-9)
    w, v = jax.numpy.linalg.eigh(jnp.asarray(cov.numpy()))
    ref = np.asarray(v * jnp.sqrt(jnp.clip(w, 0.0))[..., None, :])
    # the columns of the 20 nonzero eigenvalues, each up to its sign (the
    # null space's columns are ~1e-8 and of any direction)
    top = slice(20, 40)
    np.testing.assert_allclose(np.abs(t.numpy()[:, top]), np.abs(ref[:, top]),
                               rtol=1e-8, atol=1e-10)


def test_the_decision_is_read_once_per_tensor_and_version():
    """A tensor covariance outside ``torch.func`` transforms is decided on
    any device (a covariance computed on the card took the Cholesky
    factor's NaN before): the decision is kept for the tensor, read again
    after an in-place change, and dropped when the tensor is freed."""
    import importlib

    mv = importlib.import_module("modppl_tpu_torch.dists.mvnormal")
    cov = torch.tensor(RANK_DEFICIENT["rank2_of_3"], dtype=F64)
    assert torch.is_tensor(factor(cov))
    key = id(cov)
    assert mv._DECIDED[key] == (cov._version, True)
    assert torch.is_tensor(factor(cov))
    cov.copy_(torch.tensor(((2.0, 0.3, 0.0), (0.3, 1.0, 0.0),
                            (0.0, 0.0, 1.0)), dtype=F64))
    L = factor(cov)
    assert isinstance(L, list) and mv._DECIDED[key] == (cov._version, False)
    np.testing.assert_allclose(
        [[float(v) for v in row] for row in L],
        np.linalg.cholesky(cov.numpy()), rtol=1e-14, atol=1e-14)
    del cov, L
    assert key not in mv._DECIDED
