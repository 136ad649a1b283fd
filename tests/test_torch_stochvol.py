"""The stochastic volatility model (``models/stochvol.py``), port vs
reference on the CPU in float64.

Parity on injected values: the SV kernel's weights at given h (fully
constrained generates), the joint form's log-density at the same z,
``volatility_path``, and ``simulate_sv`` fed the reference's own eps and
eta. Then the three gates of ``tests/test_stochvol.py`` at their bounds, on
the reference's simulated data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu.models import stochvol as jsv
from modppl_tpu_torch.core.keys import split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.hmc import (
    detect_quadratic_target,
    flat_target,
    hmc,
)
from modppl_tpu_torch.inference.vsmc import batched_particle_filter
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.models.stochvol import (
    SVParams,
    make_stochvol_joint,
    simulate_sv,
    sv_scan_kernel,
    volatility_path,
)
from _torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-12)
PARAMS = [SVParams(), SVParams(mu=-1.0, phi=0.9, sigma=0.8)]


@pytest.fixture(autouse=True)
def _float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _j(p):
    return jsv.SVParams(p.mu, p.phi, p.sigma, p.beta)


def _reference_path(key, T, params):
    """The reference's simulate_sv and the eps, eta it drew."""
    k1, k2 = jax.random.split(key)
    eps = np.asarray(jax.random.normal(k1, (T,)))
    eta = np.asarray(jax.random.normal(k2, (T,)))
    hs, ys = jsv.simulate_sv(key, T, _j(params))
    return np.asarray(hs), np.asarray(ys), eps, eta


@pytest.mark.parametrize("params", PARAMS, ids=["default", "informative"])
def test_simulate_sv_on_reference_draws(params):
    hs, ys, eps, eta = _reference_path(jax.random.PRNGKey(5), 40, params)
    got_h, got_y = simulate_sv(0, 40, params, device="cpu",
                               draws=(tensor(eps), tensor(eta)))
    np.testing.assert_allclose(got_h.numpy(), hs, **TOL)
    np.testing.assert_allclose(got_y.numpy(), ys, **TOL)
    # drawn from its own keys: the same structure, and the same path twice
    a = simulate_sv(3, 40, params, device="cpu")
    b = simulate_sv(3, 40, params, device="cpu")
    assert a[0].shape == (40,) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("params", PARAMS, ids=["default", "informative"])
def test_volatility_path_matches_reference(params):
    z = np.random.default_rng(1).standard_normal((6, 25))
    want = np.asarray(jsv.volatility_path(jnp.asarray(z), _j(params)))
    np.testing.assert_allclose(volatility_path(tensor(z), params).numpy(),
                               want, **TOL)


@pytest.mark.parametrize("params", PARAMS, ids=["default", "informative"])
def test_sv_kernel_weights_match_reference(params):
    """Both generates fully constrained at 64 values of h (and prev): the
    weights (logp of h and y) over the lanes equal the reference's vmap."""
    rng = np.random.default_rng(2)
    h = rng.standard_normal(64) - 1.0
    prev = rng.standard_normal(64) - 1.0
    y = 0.4
    jk, k = jsv.sv_scan_kernel(_j(params)), sv_scan_kernel(params)
    cons_j = lambda hv: JTrie.from_dict({"h": hv, "y": jnp.asarray(y)})
    want_init = jax.vmap(lambda hv: jk.init.generate(
        jax.random.PRNGKey(0), (jnp.zeros(()),), cons_j(hv))[1])(h)
    want_step = jax.vmap(lambda hv, pv: jk.step.generate(
        jax.random.PRNGKey(0), (1, pv), cons_j(hv))[1])(h, prev)
    keys = split_keys(1, 64, "cpu")
    cons = Trie.from_dict({"h": tensor(h), "y": torch.tensor(y)})
    _, w_init = k.init.generate(keys, (torch.zeros(()),), cons)
    _, w_step = k.step.generate(keys, (1, tensor(prev)), cons)
    np.testing.assert_allclose(w_init.numpy(), np.asarray(want_init), **TOL)
    np.testing.assert_allclose(w_step.numpy(), np.asarray(want_step), **TOL)


def test_stochvol_joint_log_density_matches_reference():
    params = PARAMS[1]
    T = 16
    _, ys, _, _ = _reference_path(jax.random.PRNGKey(0), T, params)
    z = np.random.default_rng(4).standard_normal(T)
    jm = jsv.make_stochvol_joint(T, _j(params))
    _, want = jm.generate(jax.random.PRNGKey(0), (jnp.asarray(ys),),
                          JTrie.from_dict({"z": jnp.asarray(z)}))
    m = make_stochvol_joint(T, params)
    tr, got = m.generate(0, (tensor(ys),), Trie.from_dict({"z": tensor(z)}))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(tr.retv.numpy(), np.asarray(
        jsv.volatility_path(jnp.asarray(z), _j(params))), **TOL)


def _grid_log_ml(ys, params, m=400, lo=-4.0, hi=2.0):
    """tests/test_stochvol.py:27-47: exact filtering on an m-point h-grid."""
    import scipy.stats as st

    mu, phi, sigma, beta = params.mu, params.phi, params.sigma, params.beta
    grid = np.linspace(lo, hi, m)
    w = grid[1] - grid[0]
    sd0 = sigma / np.sqrt(1 - phi * phi)
    trans = st.norm(mu + phi * (grid[:, None] - mu),
                    sigma).pdf(grid[None, :]) * w
    alpha = st.norm(mu, sd0).pdf(grid) * w
    total = 0.0
    for t, y in enumerate(ys):
        if t > 0:
            alpha = alpha @ trans
        alpha = alpha * st.norm(0.0, beta * np.exp(grid / 2.0)).pdf(y)
        s = alpha.sum()
        total += np.log(s)
        alpha /= s
    return total


def _constraints(ys):
    return (Trie.from_dict({"y": tensor(ys[0])}),
            Trie.from_dict({"y": tensor(ys[1:])}))


def test_sv_filter_log_ml_matches_grid_oracle():
    params = SVParams()
    _, ys, _, _ = _reference_path(jax.random.PRNGKey(0), 12, params)
    want = _grid_log_ml(ys, params)
    init_c, step_c = _constraints(ys)
    out = batched_particle_filter(
        1, sv_scan_kernel(params), torch.zeros(()), init_c, step_c, 8192,
        ess_threshold=0.5, auto_batch=True, device="cpu")
    assert float(out["log_ml"]) == pytest.approx(want, abs=0.1)
    assert 0 < int(out["resampled"].sum())


def test_sv_posterior_tracks_true_volatility():
    params = SVParams(sigma=0.3)
    hs, ys, _, _ = _reference_path(jax.random.PRNGKey(2), 30, params)
    init_c, step_c = _constraints(ys)
    out = batched_particle_filter(
        3, sv_scan_kernel(params), torch.zeros(()), init_c, step_c, 4096,
        ess_threshold=0.5, auto_batch=True, device="cpu")
    w = torch.softmax(out["log_weights"], 0)
    mean = float(torch.sum(w * out["state"]))
    sd = float(torch.sqrt(torch.sum(w * (out["state"] - mean) ** 2)))
    assert abs(mean - float(hs[-1])) < 4 * sd + 0.5


def test_stochvol_joint_hmc_recovers_path():
    """tests/test_stochvol.py's whole-path HMC gate: detection refuses the
    non-quadratic target, the accept rate is healthy and the posterior path
    correlates with the simulated truth. Shortened for tier-1 (16 chains,
    60 + 100 at L = 16, the last 50 kept; the reference runs 300 + 400
    and keeps the last 200: a value-and-grad call through the 32-step path
    costs ~7 ms here); bounds unchanged."""
    T = 32
    params = PARAMS[1]
    h_true, ys, _, _ = _reference_path(jax.random.PRNGKey(0), T, params)
    model = make_stochvol_joint(T, params)
    tr, _ = model.generate(1, (tensor(ys),), Trie())
    target = flat_target(model, (tensor(ys),), tr, Trie(), device="cpu")
    assert detect_quadratic_target(target.logprob, target.u0.shape[0],
                                   target.u0.dtype, device="cpu") is None
    out = hmc(2, model, (tensor(ys),), Trie(), num_samples=100,
              num_warmup=60, num_chains=16, num_leapfrog=16, device="cpu")
    assert not bool(out["fused_quadratic"])
    acc = float(torch.mean(torch.as_tensor(out["accept_prob"])))
    assert 0.5 < acc < 0.99, acc
    zs = out["samples"]["z"][:, 50:]
    h_mean = volatility_path(zs, params).reshape(-1, T).mean(0).numpy()
    corr = np.corrcoef(h_mean, h_true)[0, 1]
    assert corr > 0.4, corr
    assert np.all(np.abs(h_mean - params.mu) < 4.0)
