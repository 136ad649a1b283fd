"""The unrolled small linear algebra and the Kalman filters, port vs
reference (CPU, float64).

Each ``ops/smalllinalg.py`` function is held to the JAX package's at 1e-12
for k = 1, 2, 3, 5 and 8; each Kalman entry point to the reference's on
``tests/test_kalman.py``'s LGSSM data at 1e-9, and the parallel forms to
the port's sequential ones at 1e-9. The reference's gates of
``tests/test_kalman.py`` run on the port beside them (its SMC gate through
the port's batched filter). Its
``test_kalman_hlo_no_custom_calls`` has no counterpart: it checks XLA's
lowering, and the port has no XLA program (its small solves are unrolled
torch ops, ``ops/smalllinalg.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.inference import kalman as jk
from modppl_tpu.models import lgssm as jlgssm
from modppl_tpu.ops import smalllinalg as jsl
from modppl_tpu_torch.inference import kalman as tk
from modppl_tpu_torch.interop import lgssm_params_from_numpy, tensor
from modppl_tpu_torch.ops import smalllinalg as tsl
from _torch_threads import one_thread  # noqa: F401

LINALG_TOL = dict(rtol=1e-12, atol=1e-12)
KALMAN_TOL = dict(rtol=1e-9, atol=1e-9)
DIMS = (1, 2, 3, 5, 8)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **tol)


def _psd(rng, k, batch=4):
    M = rng.normal(size=(batch, k, k))
    return M @ np.swapaxes(M, -1, -2) + k * np.eye(k)


@pytest.mark.parametrize("k", DIMS)
def test_small_linalg_matches_reference(k):
    rng = np.random.default_rng(10 + k)
    S = _psd(rng, k)
    L = np.linalg.cholesky(S)
    B = rng.normal(size=(4, k, 3))
    b = rng.normal(size=(4, k))
    G = rng.normal(size=(4, k, k))
    G[:, 0, 0] = 1e-30            # the first pivot needs a row swap
    cases = [
        ("cholesky_small", (S,)),
        ("solve_lower_small", (L, b)),
        ("solve_upper_small", (np.swapaxes(L, -1, -2), b)),
        ("solve_psd_small", (S, B)),
        ("solve_psd_small", (S, b)),
        ("lu_solve_small", (G, B)),
        ("matvec_small", (G, b)),
        ("tril_logdet_small", (L,)),
    ]
    for name, args in cases:
        got = getattr(tsl, name)(*(tensor(a) for a in args))
        want = getattr(jsl, name)(*(jnp.asarray(a) for a in args))
        _close(got, want, LINALG_TOL)
    # and against dense linear algebra, as the reference's own test does
    np.testing.assert_allclose(
        tsl.solve_psd_small(tensor(S), tensor(B)).numpy(),
        np.linalg.solve(S, B), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tsl.lu_solve_small(tensor(G), tensor(B)).numpy(),
                               np.linalg.solve(G, B), rtol=1e-7, atol=1e-7)


def test_cholesky_small_gives_nan_when_not_positive_definite():
    bad = tensor(np.array([[1.0, 2.0], [2.0, 1.0]]))
    assert bool(torch.isnan(tsl.cholesky_small(bad)).any())


def _ref_params(D=3, E=2, seed=0):
    """tests/test_kalman.py's _params."""
    rng = np.random.default_rng(seed)
    A = 0.9 * np.linalg.qr(rng.normal(size=(D, D)))[0]
    Q = 0.1 * np.eye(D)
    H = rng.normal(size=(E, D))
    R = 0.5 * np.eye(E)
    return jlgssm.make_lgssm(A, Q, H, R, np.zeros(D), np.eye(D))


def _port_params(jparams):
    return lgssm_params_from_numpy(*(np.asarray(x) for x in (
        jparams.A, jparams.Q, jparams.H, jparams.R, jparams.mu0,
        jparams.P0)))


@pytest.fixture(scope="module")
def lgssm_data():
    jparams = _ref_params()
    _, ys = jlgssm.lgssm_simulate(jax.random.PRNGKey(0), jparams, 50)
    return jparams, _port_params(jparams), ys


ENTRIES = ("kalman_filter", "kalman_filter_parallel", "kalman_smoother",
           "kalman_smoother_parallel")


@pytest.mark.parametrize("entry", ENTRIES)
def test_kalman_matches_reference(lgssm_data, entry):
    jparams, params, ys = lgssm_data
    want = getattr(jk, entry)(jparams, ys)
    got = getattr(tk, entry)(params, tensor(np.asarray(ys)), device="cpu")
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], KALMAN_TOL)


def test_parallel_filter_matches_sequential(lgssm_data):
    _, params, ys = lgssm_data
    ys = tensor(np.asarray(ys))
    seq = tk.kalman_filter(params, ys, device="cpu")
    par = tk.kalman_filter_parallel(params, ys, device="cpu")
    for k in seq:
        _close(par[k], seq[k].numpy(), KALMAN_TOL)


def test_parallel_smoother_matches_sequential(lgssm_data):
    _, params, ys = lgssm_data
    ys = tensor(np.asarray(ys))
    seq = tk.kalman_smoother(params, ys, device="cpu")
    par = tk.kalman_smoother_parallel(params, ys, device="cpu")
    for k in ("means", "covs"):
        _close(par[k], seq[k].numpy(), KALMAN_TOL)


def test_smoother_final_step_equals_filter(lgssm_data):
    _, params, ys = lgssm_data
    ys = tensor(np.asarray(ys))
    filt = tk.kalman_filter(params, ys, device="cpu")
    smth = tk.kalman_smoother(params, ys, device="cpu")
    _close(smth["means"][-1], filt["means"][-1].numpy(),
           dict(rtol=0, atol=1e-10))
    _close(smth["covs"][-1], filt["covs"][-1].numpy(),
           dict(rtol=0, atol=1e-10))
    # smoothing reduces (or keeps) the marginal variance at every step
    var_s = torch.diagonal(smth["covs"], dim1=1, dim2=2)
    var_f = torch.diagonal(filt["covs"], dim1=1, dim2=2)
    assert bool(torch.all(var_s <= var_f + 1e-9))


@pytest.mark.parametrize("entry", ("kalman_filter", "kalman_filter_parallel"))
def test_scalar_lgssm_analytic(entry):
    """1-D model with H = 1: one filter step has the textbook closed form."""
    params = lgssm_params_from_numpy(*(np.array(x, np.float64) for x in (
        [[0.9]], [[0.2]], [[1.0]], [[0.3]], [0.0], [[1.0]])))
    out = getattr(tk, entry)(params, tensor(np.array([[0.7]])), device="cpu")
    S = 1.0 + 0.3
    np.testing.assert_allclose(float(out["means"][0, 0]), 0.7 / S,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(out["covs"][0, 0, 0]), 1.0 - 1.0 / S,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        float(out["log_ml"]), -0.5 * (np.log(2 * np.pi * S) + 0.7 ** 2 / S),
        rtol=0, atol=1e-12)


def test_smc_log_ml_matches_kalman():
    """Bootstrap SMC on the LGSSM against the exact Kalman evidence: the
    reference's gate (tests/test_kalman.py: D = 2, E = 1, 8 steps, 4096
    particles, within 0.08) on its own data, through the port's batched
    filter and the port's Kalman filter."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.inference.vsmc import batched_particle_filter
    from modppl_tpu_torch.models.lgssm import lgssm_scan_kernel

    jparams = _ref_params(D=2, E=1, seed=1)
    params = _port_params(jparams)
    _, ys = jlgssm.lgssm_simulate(jax.random.PRNGKey(3), jparams, 8)
    ys = tensor(np.asarray(ys))
    exact = float(tk.kalman_filter(params, ys, device="cpu")["log_ml"])
    np.testing.assert_allclose(
        exact, float(jk.kalman_filter(jparams, jnp.asarray(ys.numpy()))[
            "log_ml"]), **KALMAN_TOL)
    out = batched_particle_filter(
        4, lgssm_scan_kernel(params), torch.zeros(2, dtype=torch.float64),
        Trie.from_dict({"obs": ys[0]}), Trie.from_dict({"obs": ys[1:]}),
        4096, auto_batch=True, device="cpu")
    assert abs(float(out["log_ml"]) - exact) < 0.08, (float(out["log_ml"]),
                                                     exact)


def test_associative_scan_matches_reference_order():
    """The port's scan combines the same pairs as jax.lax.associative_scan:
    on a non-commutative operator (2x2 products) at every length 1-9, both
    directions agree to rounding."""
    rng = np.random.default_rng(3)
    for n in range(1, 10):
        x = rng.normal(size=(n, 2, 2))
        for reverse in (False, True):
            want = jax.lax.associative_scan(
                lambda a, b: (b[0] @ a[0],), (jnp.asarray(x),),
                reverse=reverse)[0]
            got = tk.associative_scan(lambda a, b: (b[0] @ a[0],),
                                      (tensor(x),), reverse=reverse)[0]
            _close(got, want, LINALG_TOL)


def test_kalman_entries_run_on_the_card_unless_asked_for_the_cpu(
        monkeypatch, lgssm_data):
    _, params, ys = lgssm_data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in ENTRIES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tk, entry)(params, tensor(np.asarray(ys)))
        out = getattr(tk, entry)(params, np.array(ys), device="cpu")
        assert out["means"].device.type == "cpu"
