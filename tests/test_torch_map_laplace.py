"""MAP and the Laplace approximation, port vs reference (CPU, float64).

The port's functional Adam is held to optax's trajectory (1e-12), MAP to
the reference's on the same initial trace (1e-12), and the Laplace
Gaussian at the reference's mode to its covariance, factor and log-ML
(1e-9). The reference's gates (``tests/test_map_laplace.py``) run on the
port beside them. Both sides start from the same latent values: an
initial trace generated with them constrained, float64 on both sides.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu import gen as jgen
from modppl_tpu import normal as jnormal
from modppl_tpu.dists import gamma as jgamma
from modppl_tpu.dists import poisson as jpoisson
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import gamma, normal, poisson
from modppl_tpu_torch.inference import _adam
from modppl_tpu_torch.inference import map_laplace as tml
from modppl_tpu_torch.inference.hmc import flat_target
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

jml = importlib.import_module("modppl_tpu.inference.map_laplace")

ADAM_TOL = dict(rtol=1e-12, atol=1e-12)
LAPLACE_TOL = dict(rtol=1e-9, atol=1e-9)


@jgen
def jconjugate(h):
    mu = h.sample(jnormal, (0.0, 1.0), "mu")
    h.sample(jnormal, (mu, 0.5), "x")
    return mu


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 0.5), "x")
    return mu


@jgen
def jpoisson_gamma(h):
    lam = h.sample(jgamma, (2.0, 1.0), "lam")
    h.sample(jpoisson, (lam,), "k")
    return lam


@gen
def poisson_gamma(h):
    lam = h.sample(gamma, (2.0, 1.0), "lam")
    h.sample(poisson, (lam,), "k")
    return lam


OBS = Trie.from_dict({"x": 1.0})
POBS = Trie.from_dict({"k": 3})
# (reference model, port model, observations, latent, its start value)
MODELS = {
    "conjugate": (jconjugate, conjugate, {"x": 1.0}, "mu", -0.4),
    "poisson_gamma": (jpoisson_gamma, poisson_gamma, {"k": 3}, "lam", 1.3),
}


def _init_traces(name):
    """Both sides' initial traces at the same float64 latent value."""
    jmodel, tmodel, obs, addr, x0 = MODELS[name]
    jtr, _ = jmodel.generate(jax.random.PRNGKey(0), (),
                             JTrie.from_dict({**obs, addr: x0}))
    ttr, _ = tmodel.generate(0, (), Trie.from_dict(
        {**obs, addr: torch.tensor(x0, dtype=torch.float64)}), device="cpu")
    return jtr, ttr


def _objectives(name, jacobian):
    jmodel, tmodel, obs, _, _ = MODELS[name]
    jtr, ttr = _init_traces(name)
    jobj, ju0, _ = jml._make_objective(jmodel, (), jtr, JTrie.from_dict(obs),
                                       None, jacobian)
    tobj, tu0, _, _, _ = flat_target(tmodel, (), ttr, Trie.from_dict(obs),
                                     None, jacobian, torch.device("cpu"))
    np.testing.assert_array_equal(tu0.numpy(), np.asarray(ju0))
    return jobj, tobj


@pytest.mark.parametrize("name", list(MODELS))
def test_adam_trajectory_matches_optax(name):
    """Five restarts from injected points, 50 steps: every intermediate
    point of the port's batched Adam equals optax's."""
    jobj, tobj = _objectives(name, True)
    inits = np.random.default_rng(1).standard_normal((5, 1))
    opt = optax.adam(0.05)
    vg = jax.vmap(jax.value_and_grad(jobj))
    u, st = jnp.asarray(inits), opt.init(jnp.asarray(inits))
    want = []
    for _ in range(50):
        _, g = vg(u)
        upd, st = opt.update(-g, st)
        u = optax.apply_updates(u, upd)
        want.append(np.asarray(u))
    for steps in (1, 7, 50):
        got, vals = tml._adam_restarts(tobj, tensor(inits), steps, 0.05)
        np.testing.assert_allclose(got.numpy(), want[steps - 1], **ADAM_TOL)
    np.testing.assert_allclose(vals.numpy(),
                               np.asarray(jax.vmap(jobj)(u)), **ADAM_TOL)


def test_adam_schedule_matches_optax():
    """adam_step on a (mu, log_sigma) pair under exponential_decay equals
    optax.adam(optax.exponential_decay(...)) step for step."""
    rng = np.random.default_rng(2)
    params = (rng.standard_normal(3), rng.standard_normal(3))
    grads = [(rng.standard_normal(3), rng.standard_normal(3))
             for _ in range(30)]
    opt = optax.adam(optax.exponential_decay(0.01, 30, 1.0 / 30.0))
    jp = tuple(jnp.asarray(p) for p in params)
    st = opt.init(jp)
    tp = tuple(tensor(p) for p in params)
    tst = _adam.adam_init(tp)
    sched = _adam.exponential_decay(0.01, 30, 1.0 / 30.0)
    for g in grads:
        upd, st = opt.update(tuple(jnp.asarray(x) for x in g), st)
        jp = optax.apply_updates(jp, upd)
        tp, tst = _adam.adam_step(tp, tuple(tensor(x) for x in g), tst, sched)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **ADAM_TOL)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("jacobian", (False, True))
def test_map_matches_reference(name, jacobian):
    """One restart (the initial trace's values, no jitter on either side):
    the optimum, its value and the constrained parameters agree."""
    jmodel, tmodel, obs, addr, _ = MODELS[name]
    jtr, ttr = _init_traces(name)
    kw = dict(num_steps=200, learning_rate=0.03, num_restarts=1,
              jacobian=jacobian)
    want = jml.map_optimize(jax.random.PRNGKey(0), jmodel, (),
                            JTrie.from_dict(obs), init_trace=jtr, **kw)
    got = tml.map_optimize(0, tmodel, (), Trie.from_dict(obs),
                           init_trace=ttr, device="cpu", **kw)
    for k in ("unconstrained", "logp", "restart_logps"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **ADAM_TOL)
    np.testing.assert_allclose(got["params"][addr].numpy(),
                               np.asarray(want["params"][addr]), **ADAM_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_laplace_matches_reference(name):
    """At the reference's mode the port's covariance, factor and log-ML
    agree at 1e-9, and so does the whole approximation from one restart."""
    jmodel, tmodel, obs, _, _ = MODELS[name]
    jtr, ttr = _init_traces(name)
    kw = dict(num_steps=300, learning_rate=0.03, num_restarts=1)
    want = jml.laplace_approximation(jax.random.PRNGKey(0), jmodel, (),
                                     JTrie.from_dict(obs), init_trace=jtr,
                                     **kw)
    _, tobj = _objectives(name, True)
    cov, chol, log_ml = tml._laplace_at(tobj, tensor(np.asarray(want["mean"])),
                                        tensor(np.asarray(want["logp"])))
    for got, k in ((cov, "cov"), (chol, "chol"), (log_ml, "log_ml")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]),
                                   **LAPLACE_TOL)
    got = tml.laplace_approximation(0, tmodel, (), Trie.from_dict(obs),
                                    init_trace=ttr, device="cpu", **kw)
    for k in ("mean", "cov", "chol", "log_ml", "logp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **LAPLACE_TOL)


# --------------------------------------------------------------------------
# the reference's gates (tests/test_map_laplace.py), on the port
# --------------------------------------------------------------------------

def test_map_conjugate_normal_mode():
    # posterior N(0.8, 0.2); unconstrained == constrained (no bijector)
    out = tml.map_optimize(0, conjugate, (), OBS, num_steps=400,
                           device="cpu")
    assert abs(float(out["params"]["mu"]) - 0.8) < 1e-3
    lps = out["restart_logps"].numpy()
    np.testing.assert_allclose(lps, lps[0], atol=1e-5)


def test_laplace_conjugate_normal_exact():
    """Laplace is exact for a Gaussian posterior: mean, covariance and log
    marginal likelihood all match analytic values."""
    out = tml.laplace_approximation(0, conjugate, (), OBS, num_steps=400,
                                    device="cpu")
    assert abs(float(out["mean"][0]) - 0.8) < 1e-3
    assert abs(float(out["cov"][0, 0]) - 0.2) < 1e-3
    log_ml_exact = float(-0.5 * np.log(2 * np.pi * 1.25) - 0.5 / 1.25)
    assert abs(float(out["log_ml"]) - log_ml_exact) < 1e-3
    draws = out["sample"](1, 4000)["mu"]
    assert abs(float(torch.mean(draws)) - 0.8) < 0.03
    assert abs(float(torch.std(draws)) - np.sqrt(0.2)) < 0.03


def test_map_constrained_space_mode():
    """jacobian=False: the constrained posterior mode, gamma(5, 1/2) -> 2;
    jacobian=True: the mode in log-lambda coordinates -> 2.5."""
    out = tml.map_optimize(0, poisson_gamma, (), POBS, num_steps=600,
                           learning_rate=0.03, device="cpu")
    assert abs(float(out["params"]["lam"]) - 2.0) < 5e-3
    out_j = tml.map_optimize(0, poisson_gamma, (), POBS, num_steps=600,
                             learning_rate=0.03, jacobian=True, device="cpu")
    assert abs(float(out_j["params"]["lam"]) - 2.5) < 5e-3


def test_laplace_log_ml_poisson_gamma():
    """Laplace log-ML vs the exact negative-binomial marginal p(k=3) = 1/8;
    samples respect positivity; their mean is the lognormal's, 2.5 e^0.1."""
    out = tml.laplace_approximation(0, poisson_gamma, (), POBS,
                                    num_steps=600, learning_rate=0.03,
                                    device="cpu")
    assert abs(float(out["log_ml"]) - float(np.log(0.125))) < 0.05
    draws = out["sample"](1, 2000)["lam"]
    assert float(torch.min(draws)) > 0.0
    assert abs(float(torch.mean(draws)) - 2.5 * np.exp(0.1)) < 0.15


def test_laplace_raises_on_a_saddle():
    """A flat direction (a latent the density ignores beyond its prior,
    read at a point where the curvature is positive) raises ValueError."""
    @gen
    def bumpy(h):
        a = h.sample(normal, (0.0, 1.0), "a")
        h.factor(2.0 * a * a, "lift")     # net curvature +3: a minimum
        return a

    with pytest.raises(ValueError, match="not negative-definite"):
        tml.laplace_approximation(0, bumpy, (), Trie(), num_steps=1,
                                  num_restarts=1, device="cpu")


def test_map_laplace_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for f in (tml.map_optimize, tml.laplace_approximation):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            f(0, conjugate, (), OBS, num_steps=2)
        out = f(0, conjugate, (), OBS, num_steps=2, device="cpu")
        assert out["logp"].device.type == "cpu"
