"""The GP regression model, port vs reference (CPU).

``model.assess`` and the posterior predictive are held to the JAX
package's on the same float64 hyperparameters (1e-10); the reference's
four gates (``tests/test_gp.py``) run on the port: the dense-MVN oracle,
the predictive against the closed form, MAP of the hyperparameters
(``inference/map_laplace``) and generic HMC (``inference/hmc``). The
reference's predictive omits the model's jitter and does not clamp its
variance at 0 (``modppl_tpu/models/gp.py:60``, ROADMAP Queue 3): the port
does both, and ``test_reference_predictive_fault`` marks the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from modppl_tpu import Trie as JTrie
from modppl_tpu.models import gp as jgp
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.hmc import hmc
from modppl_tpu_torch.inference.map_laplace import map_optimize
from modppl_tpu_torch.models import gp as tgp
from _torch_threads import one_thread  # noqa: F401

XS = np.linspace(-2.0, 2.0, 12)
JITTER = 1e-6
F64 = torch.float64


def _dense_k(xs, amp, ls, noise, jitter):
    return (amp ** 2 * np.exp(-0.5 * (xs[:, None] - xs[None, :]) ** 2
                              / ls ** 2)
            + (noise ** 2 + jitter) * np.eye(len(xs)))


def _true_marginal_logpdf(y, amp, ls, noise, jitter=JITTER):
    K = _dense_k(XS.astype(np.float32).astype(np.float64), amp, ls, noise,
                 jitter)
    sign, logdet = np.linalg.slogdet(K)
    assert sign > 0
    return float(-0.5 * y @ np.linalg.solve(K, y) - 0.5 * logdet
                 - 0.5 * len(XS) * np.log(2 * np.pi))


def _choices(la, ll, ln, y):
    return {"log_amp": la, "log_ls": ll, "log_noise": ln, "y": y}


def test_gp_assess_matches_reference():
    """Float64 hyperparameters and data: the port's log joint equals the
    reference's (both square float32 input differences, then compute in
    float64)."""
    y = np.random.default_rng(0).standard_normal(len(XS))
    rng = np.random.default_rng(1)
    for la, ll, ln in rng.normal(size=(3, 3)) * 0.5:
        want = jgp.make_gp_model(XS).assess(
            jax.random.PRNGKey(0), (),
            JTrie.from_dict(_choices(la, ll, ln, jnp.asarray(y))))
        got = tgp.make_gp_model(XS, device="cpu").assess(
            0, (), Trie.from_dict(_choices(
                *(torch.tensor(v, dtype=F64) for v in (la, ll, ln)),
                torch.tensor(y))), device="cpu")
        np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def test_gp_assess_matches_dense_mvn_logpdf():
    """model.assess on fully observed choices = the hyperprior logpdfs +
    the exact dense multivariate-normal marginal."""
    model = tgp.make_gp_model(XS, device="cpu")
    y = np.random.default_rng(0).standard_normal(len(XS))
    la, ll, ln = 0.3, -0.2, -1.5
    w = float(model.assess(0, (), Trie.from_dict(_choices(
        la, ll, ln, torch.tensor(y, dtype=torch.float32))), device="cpu"))
    expected = (stats.norm.logpdf(la, 0, 1) + stats.norm.logpdf(ll, 0, 1)
                + stats.norm.logpdf(ln, -2, 1)
                + _true_marginal_logpdf(y, np.exp(la), np.exp(ll),
                                        np.exp(ln)))
    np.testing.assert_allclose(w, expected, rtol=1e-4)


def test_gp_posterior_predictive_interpolates():
    """With tiny noise the predictive passes through the training targets
    with near-zero variance, and matches the dense closed form (with the
    model's jitter) at held-out points."""
    amp, ls, noise = 1.0, 0.7, 1e-3
    y = np.sin(XS)
    mean_tr, var_tr = tgp.gp_posterior_predictive(XS, y, XS, amp, ls, noise,
                                                  device="cpu")
    np.testing.assert_allclose(mean_tr.numpy(), y, atol=5e-3)
    assert float(torch.max(var_tr)) < 1e-3
    assert float(torch.min(var_tr)) >= 0.0

    xstar = np.asarray([-1.3, 0.4, 1.9])
    mean, var = tgp.gp_posterior_predictive(XS, y, xstar, amp, ls, noise,
                                            device="cpu")
    K = _dense_k(XS, amp, ls, noise, JITTER)
    Ks = tgp.rbf_kernel(torch.tensor(xstar), torch.tensor(XS), amp,
                        ls).numpy()
    np.testing.assert_allclose(mean.numpy(), Ks @ np.linalg.solve(K, y),
                               rtol=1e-4, atol=1e-5)
    assert np.all(var.numpy() > 0)


def test_predictive_matches_reference_with_its_jitter():
    """Given the same covariance (jitter 0, float32 inputs as the
    reference casts them) the port's predictive is the reference's."""
    amp, ls, noise = 0.9, 0.6, 0.3
    y = np.cos(XS)
    xstar = np.asarray([-1.7, -0.2, 0.5, 1.1])
    want = jgp.gp_posterior_predictive(XS, y, xstar, amp, ls, noise)
    got = tgp.gp_posterior_predictive(
        *(torch.tensor(a, dtype=torch.float32) for a in (XS, y, xstar)),
        amp, ls, noise, jitter=0.0, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-6)


def test_reference_predictive_fault():
    """The reference's predictive leaves the model's jitter out of K
    (``modppl_tpu/models/gp.py:60``) and does not clamp the variance: at a
    near-noiseless fit (noise 1e-4) its variance between the training
    points falls below 0 in float32, and its mean solves another system
    than the model's marginal. The port clamps and includes the jitter;
    this marks the difference as the reference's fault."""
    amp, ls, noise = 1.0, 0.7, 1e-4
    y = np.sin(XS)
    xstar = np.linspace(-2.0, 2.0, 23)
    ref_mean, ref_var = jgp.gp_posterior_predictive(XS, y, xstar, amp, ls,
                                                    noise)
    mean, var = tgp.gp_posterior_predictive(XS, y, xstar, amp, ls, noise,
                                            device="cpu")
    assert float(jnp.min(ref_var)) < 0.0
    assert float(torch.min(var)) >= 0.0
    # the port's mean is the jittered system's; the reference's is not
    Ks = amp ** 2 * np.exp(-0.5 * (xstar[:, None] - XS[None, :]) ** 2
                           / ls ** 2)
    want = Ks @ np.linalg.solve(_dense_k(XS, amp, ls, noise, JITTER), y)
    no_jitter = Ks @ np.linalg.solve(_dense_k(XS, amp, ls, noise, 0.0), y)
    np.testing.assert_allclose(mean.numpy(), want, rtol=0, atol=1e-8)
    # the reference solves the unjittered system (to float32 rounding,
    # ~5e-7 here), ~1e-5 away from the model's
    ref_mean = np.asarray(ref_mean)
    assert np.abs(ref_mean - no_jitter).max() < 2e-6
    assert np.abs(ref_mean - want).max() > 5e-6


def _data():
    model = tgp.make_gp_model(XS, device="cpu")
    sim = Trie.from_dict({"log_amp": 0.0, "log_ls": -0.3, "log_noise": -2.3})
    tr, _ = model.generate(3, (), sim, device="cpu")
    return model, tr.data.read("y")


def test_gp_hyperparameter_map_recovers_scales():
    """MAP over the log hyperparameters of data drawn from the model at
    known values lands near them and beats the prior-mean values on the
    log joint (non-quadratic: the generic gradient path)."""
    model, y = _data()
    out = map_optimize(0, model, (), Trie.from_dict({"y": y}),
                       num_steps=600, learning_rate=0.03, device="cpu")
    assert abs(float(out["params"]["log_ls"]) - (-0.3)) < 1.0
    assert abs(float(out["params"]["log_amp"]) - 0.0) < 1.5
    base = Trie.from_dict({"log_amp": 0.0, "log_ls": 0.0, "log_noise": -2.0,
                           "y": y})
    fit = Trie.from_dict({**{k: v for k, v in out["params"].items()},
                          "y": y})
    assert float(model.assess(0, (), fit, device="cpu")) >= \
        float(model.assess(0, (), base, device="cpu")) - 1e-3


def test_gp_hmc_posterior_on_hyperparameters():
    """Pooled-adaptation HMC over the 3 log hyperparameters mixes and stays
    near the generating length scale (generic path, no detection).

    Shortened for time, bounds unchanged: 30 + 60 iterations at L = 6, the
    second half kept (the reference: 75 + 150 at L = 8, the second half).
    A value-and-grad call through the 12-point unrolled Cholesky costs ~35
    ms on a CPU, and ~75 ms of host dispatch on the card, where the
    reference's configuration took 136 s; it waits for the generic path's
    host cost to fall (ROADMAP Queue 3)."""
    model, y = _data()
    out = hmc(0, model, (), Trie.from_dict({"y": y}), num_samples=60,
              num_warmup=30, num_chains=8, num_leapfrog=6,
              use_fused_quadratic=False, device="cpu")
    assert not out["fused_quadratic"]
    assert float(torch.mean(out["accept_prob"])) > 0.5
    ls_draws = out["samples"]["log_ls"][:, 30:].double().numpy()
    assert abs(ls_draws.mean() - (-0.3)) < 1.2


def test_gp_entries_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgp.make_gp_model(XS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgp.gp_posterior_predictive(XS, np.sin(XS), XS, 1.0, 0.7, 0.1)
    assert tgp.make_gp_model(torch.tensor(XS)).assess(
        0, (), Trie.from_dict(_choices(0.0, 0.0, -2.0, torch.zeros(12))),
        device="cpu").device.type == "cpu"
