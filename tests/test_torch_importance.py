"""The port's importance sampling against the JAX package's (CPU, float64).

Parity: the reference's vectorized ``importance_sampling`` on
``line_model``, ``make_hierarchical_static(5)`` and the hand-coded
``PointedModel`` (4096 lanes), its lane values handed to the port through
``pool=``: log-weights, normalized weights and log-ML equal at 1e-10. Then
the reference's own quantitative gates of tests/test_importance.py on the
port alone (conjugate log-ML and moments, the line posterior, resampled
indices, PointedModel in both modes, the eager hierarchical model), and
the port's rules: a GenFn without a batched generate raises under
``vectorized=True``, and the default device is the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu.inference import importance_sampling as j_importance_sampling
from modppl_tpu.models import Bounds as JBounds
from modppl_tpu.models import PointedModel as JPointedModel
from modppl_tpu.models import line_model as j_line_model
from modppl_tpu.models.hierarchical_static import (
    make_hierarchical_static as j_make_hierarchical_static,
)
from modppl_tpu_torch.core import Trie
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.inference import (
    importance_resampling,
    importance_sampling,
    tree_index,
)
from modppl_tpu_torch.interop import (
    bounds_from_reference,
    pool_from_reference,
    tensor,
)
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models import (
    HMM,
    Bounds,
    PointedModel,
    hierarchical_model,
    line_model,
)
from modppl_tpu_torch.models.hierarchical_static import (
    exact_hierarchical_posterior,
    make_hierarchical_static,
)
from _torch_threads import one_thread  # noqa: F401

CPU = "cpu"
LANES = 4096
TOL = dict(rtol=0.0, atol=1e-10)
XS11 = [-5.0, -4.0, -3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
XS5 = [-2.0, -1.0, 0.0, 1.0, 2.0]
YS5 = [0.3 + 0.4 * x + 0.5 * x * x for x in XS5]
COV = [[1.0, -0.6], [-0.6, 2.0]]


@pytest.fixture(autouse=True)
def float64_default():
    """The reference runs with x64: the port's default float follows."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")
    return mu


def _hold(port, ref):
    """Log-weights, normalized weights and log-ML of the two runs."""
    _, lnw, lml = port
    _, j_lnw, j_lml = ref
    assert lnw.shape == (LANES,)
    np.testing.assert_allclose(lnw.numpy(), np.asarray(j_lnw), **TOL)
    np.testing.assert_allclose(torch.exp(lnw).numpy(),
                               np.exp(np.asarray(j_lnw)), **TOL)
    np.testing.assert_allclose(float(lml), float(j_lml), **TOL)


def _line_obs(trie_cls):
    obs = trie_cls()
    for i, x in enumerate(XS11):
        obs.observe(f"ys / {i}", 0.5 * x - 1.0)
    return obs


def test_line_model_matches_reference():
    ref = j_importance_sampling(jax.random.PRNGKey(11), j_line_model,
                                (XS11,), _line_obs(JTrie), LANES)
    pool = pool_from_reference(ref[0].data)
    assert {"slope", "intercept"} <= set(pool)
    port = importance_sampling(5, line_model, (XS11,), _line_obs(Trie),
                               LANES, device=CPU, pool=pool)
    _hold(port, ref)
    # the batched trace: every leaf has the lane axis
    traces = port[0]
    assert traces.data.read("ys / 3").shape == (LANES,)
    assert traces.retv.shape == (LANES, len(XS11))
    np.testing.assert_allclose(traces.logjp.numpy(),
                               np.asarray(ref[0].logjp), **TOL)


def test_hierarchical_static_matches_reference():
    xs, ys = np.asarray(XS5), np.asarray(YS5)
    ref = j_importance_sampling(
        jax.random.PRNGKey(12), j_make_hierarchical_static(5),
        (jnp.asarray(xs),), JTrie.from_dict({"ys": jnp.asarray(ys)}), LANES)
    pool = pool_from_reference(ref[0].data)
    assert pool["is_linear"].dtype == torch.bool
    port = importance_sampling(
        5, make_hierarchical_static(5), (tensor(xs),),
        Trie.from_dict({"ys": tensor(ys)}), LANES, device=CPU, pool=pool)
    _hold(port, ref)
    one = tree_index(port[0], 7)
    assert torch.equal(one.data.read("ys"), tensor(ys))
    assert float(one.data.read("coeffs / a")) == float(
        np.asarray(ref[0].data.read("coeffs / a"))[7])
    np.testing.assert_allclose(float(one.logjp),
                               float(np.asarray(ref[0].logjp)[7]), **TOL)


def test_pointed_model_vectorized_matches_reference():
    """The hand-coded GenFn's own batched generate, its latent lanes
    the reference's."""
    jb = JBounds(-5.0, 5.0, -5.0, 5.0)
    ref = j_importance_sampling(
        jax.random.PRNGKey(13), JPointedModel(jnp.asarray(COV)), jb,
        (None, jnp.array([0.3, -0.2])), LANES)
    pool = {"latent": tensor(np.asarray(ref[0].data[0]))}
    port = importance_sampling(
        5, PointedModel(tensor(np.asarray(COV))), bounds_from_reference(jb),
        (None, tensor(np.array([0.3, -0.2]))), LANES, device=CPU, pool=pool)
    _hold(port, ref)
    assert port[0].data[1].shape == (LANES, 2)


# --------------------------------------------------------------------------
# the reference's gates (tests/test_importance.py), on the port alone
# --------------------------------------------------------------------------

def test_is_log_ml_exact_conjugate():
    obs = Trie.from_dict({"x": 1.0})
    traces, lnw, log_ml = importance_sampling(0, conjugate, (), obs, 50_000,
                                              device=CPU)
    exact = float(normal.logpdf(1.0, (0.0, math.sqrt(2.0))))
    assert float(log_ml) == pytest.approx(exact, abs=0.01)
    mus = traces.data.read("mu")
    w = torch.exp(lnw)
    post_mean = float(torch.sum(w * mus))
    post_var = float(torch.sum(w * (mus - post_mean) ** 2))
    assert post_mean == pytest.approx(0.5, abs=0.02)
    assert post_var == pytest.approx(0.5, abs=0.02)


def test_is_line_model_posterior():
    traces, lnw, _ = importance_sampling(1, line_model, (XS11,),
                                         _line_obs(Trie), 200_000, device=CPU)
    w = torch.exp(lnw)
    post_slope = float(torch.sum(w * traces.data.read("slope")))
    post_intercept = float(torch.sum(w * traces.data.read("intercept")))
    X = np.stack([np.asarray(XS11), np.ones(len(XS11))], 1)
    prior_prec = np.diag([1.0, 1.0 / 4.0])
    noise_prec = 1.0 / 0.01
    y = 0.5 * np.asarray(XS11) - 1.0
    post_cov = np.linalg.inv(prior_prec + noise_prec * X.T @ X)
    post_mean = post_cov @ (noise_prec * X.T @ y)
    assert post_slope == pytest.approx(post_mean[0], abs=0.02)
    assert post_intercept == pytest.approx(post_mean[1], abs=0.1)


def test_is_resampling_indices():
    obs = Trie.from_dict({"x": 1.0})
    traces, idx, _ = importance_resampling(2, conjugate, (), obs, 5000, 500,
                                           device=CPU)
    assert idx.shape == (500,) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 5000
    one = tree_index(traces, int(idx[0]))
    assert np.isfinite(float(one.logjp))
    # the resampled posterior mean of mu | x = 1 is 0.5
    assert float(traces.data.read("mu")[idx.long()].mean()) == pytest.approx(
        0.5, abs=0.1)


def _pointed():
    return (PointedModel(torch.tensor(COV)), Bounds(-5.0, 5.0, -5.0, 5.0),
            (None, torch.tensor([0.0, 0.0])))


def test_is_handcoded_model_loop_mode():
    model, bounds, constraints = _pointed()
    traces, lnw, log_ml = importance_sampling(
        3, model, bounds, constraints, 200, vectorized=False, device=CPU)
    assert len(traces) == 200
    assert np.isfinite(float(log_ml))
    assert lnw.shape == (200,)
    assert float(torch.exp(lnw).sum()) == pytest.approx(1.0, abs=1e-6)


def test_is_handcoded_model_vectorized():
    model, bounds, constraints = _pointed()
    _, _, log_ml = importance_sampling(3, model, bounds, constraints, 20_000,
                                       device=CPU)
    assert float(log_ml) == pytest.approx(np.log(1.0 / 100.0), abs=0.05)


def test_is_hierarchical_eager():
    obs = Trie()
    for i, y in enumerate(YS5):
        obs.observe(f"(y, {i})", y)
    traces, lnw, log_ml = importance_sampling(
        4, hierarchical_model, (XS5,), obs, 300, vectorized=False, device=CPU)
    assert np.isfinite(float(log_ml))
    n_quad = sum(1 for t in traces if t.data.search("coeffs/c") is not None)
    assert 0 <= n_quad <= 300
    for t in traces[:10]:
        assert np.isfinite(float(t.data.read("coeffs/a")))


def test_is_hierarchical_static_against_the_exact_posterior():
    """The batched leg of the chip script at 2^18 lanes: the log-ML within
    4 Monte Carlo standard errors of the exact evidence, P(is_linear)
    below 1e-3, the same key twice bitwise equal."""
    n = 1 << 18
    model = make_hierarchical_static(5)
    args, obs = (torch.tensor(XS5),), Trie.from_dict({"ys": torch.tensor(YS5)})
    traces, lnw, log_ml = importance_sampling(21, model, args, obs, n,
                                              device=CPU)
    *_, log_z = exact_hierarchical_posterior(XS5, YS5)
    ess = float(torch.exp(-torch.logsumexp(2.0 * lnw, 0)))
    assert ess > 2.0
    assert abs(float(log_ml) - log_z) < 4.0 * math.sqrt(1.0 / ess - 1.0 / n)
    w = torch.exp(lnw)
    assert float(torch.sum(w * traces.data.read("is_linear"))) < 1e-3
    assert torch.equal(lnw, importance_sampling(21, model, args, obs, n,
                                                device=CPU)[1])


@gen
def _noise(h, scale):
    return h.sample(normal, (0.0, scale), "z")


@gen
def _with_call(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    z = h.trace(_noise, (0.5,), "noise")
    h.sample(normal, (mu + z, 1.0), "x")
    return mu


def test_vectorized_calls_run_over_the_lanes():
    """A call of another @gen model under vectorized=True runs over the
    same lanes: its site with shared parameters draws one value a lane,
    and the pool reaches it below the call's address."""
    n = 512
    traces, lnw, _ = importance_sampling(
        8, _with_call, (), Trie.from_dict({"x": 0.3}), n, device=CPU)
    z = traces.data.read("noise / z")
    assert z.shape == (n,) and float(z.std()) > 0.3
    pool = {"noise / z": torch.linspace(-1.0, 1.0, n)}
    traces, lnw, _ = importance_sampling(
        8, _with_call, (), Trie.from_dict({"x": 0.3}), n, device=CPU,
        pool=pool)
    assert torch.equal(traces.data.read("noise / z"), pool["noise / z"])
    mu = traces.data.read("mu")
    want = normal.logpdf(0.3, (mu + pool["noise / z"], 1.0))
    np.testing.assert_allclose(lnw.numpy(), (want - torch.logsumexp(
        want, 0)).numpy(), **TOL)


# --------------------------------------------------------------------------
# the port's rules
# --------------------------------------------------------------------------

def test_vectorized_needs_a_batched_generate():
    with pytest.raises(TypeError, match="vectorized=False"):
        importance_sampling(0, HMM(None), (1, None), ([None], [0]), 4,
                            device=CPU)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importance_sampling(0, conjugate, (), Trie.from_dict({"x": 1.0}), 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importance_resampling(0, conjugate, (), Trie.from_dict({"x": 1.0}),
                              8, 4)
