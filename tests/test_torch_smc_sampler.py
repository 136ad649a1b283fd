"""The tempered SMC samplers and parallel tempering
(``inference/smc_sampler.py``, ``inference/tempering.py``), port vs
reference on the CPU in float64.

Parity: ``make_tempered_logprobs`` at the same u (1e-12); one HMC and one
MALA move with the reference's momenta, noise and uniforms injected;
``adaptive_smc_sampler``'s bisection on given log-likelihoods against the
reference's (pick_delta, smc_sampler.py:279-309); ``_swap_round`` on the
reference's uniforms, bitwise; ``iid``'s lane form against its
``from_standard``. Then the five gates of ``tests/test_smc_sampler.py`` at
their configurations and bounds.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu import gen as jgen
from modppl_tpu.dists import gamma as j_gamma
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.dists.iid import iid as j_iid
from modppl_tpu.inference import tempering as jpt
from modppl_tpu.utils import effective_sample_size_from_log_weights
from modppl_tpu_torch.core.keys import lanes, normal_lanes
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import gamma, normal
from modppl_tpu_torch.dists.iid import iid
from modppl_tpu_torch.inference.hmc import _value_and_grad
from modppl_tpu_torch.inference.smc_sampler import (
    adaptive_smc_sampler,
    make_tempered_logprobs,
    smc_sampler,
)
from modppl_tpu_torch.inference.tempering import (
    _swap_round,
    parallel_tempering,
)
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

# the packages export the function smc_sampler under the module's name
jsmcs = importlib.import_module("modppl_tpu.inference.smc_sampler")
smcs = importlib.import_module("modppl_tpu_torch.inference.smc_sampler")

TOL = dict(rtol=1e-12, atol=1e-12)
YS = np.array([0.8, 1.2, 1.0])
_PREC = 1.0 + 3.0 / 0.25
_POST_MEAN = (YS.sum() / 0.25) / _PREC
_POST_STD = 1.0 / np.sqrt(_PREC)


@pytest.fixture(autouse=True)
def _float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _exact_log_ml():
    cov = 0.25 * np.eye(3) + np.ones((3, 3))
    _, logdet = np.linalg.slogdet(2 * np.pi * cov)
    return float(-0.5 * (logdet + YS @ np.linalg.solve(cov, YS)))


ys3 = iid(normal, 3)
j_ys3 = j_iid(j_normal, 3)


@gen
def nn_model(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(ys3, (mu, 0.5), "ys")
    return mu


@jgen
def j_nn_model(h):
    mu = h.sample(j_normal, (0.0, 1.0), "mu")
    h.sample(j_ys3, (mu, 0.5), "ys")
    return mu


@gen
def scale_model(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    s = h.sample(gamma, (2.0, 1.0), "s")
    h.sample(ys3, (mu, s), "ys")
    return mu


@jgen
def j_scale_model(h):
    mu = h.sample(j_normal, (0.0, 1.0), "mu")
    s = h.sample(j_gamma, (2.0, 1.0), "s")
    h.sample(j_ys3, (mu, s), "ys")
    return mu


OBS = Trie.from_dict({"ys": tensor(YS)})
J_OBS = JTrie.from_dict({"ys": jnp.asarray(YS)})
MODELS = {"nn": (nn_model, j_nn_model), "scale": (scale_model, j_scale_model)}


def _both(name):
    model, jmodel = MODELS[name]
    jtr, _ = jmodel.generate(jax.random.PRNGKey(0), (), J_OBS)
    tr, _ = model.generate(0, (), OBS, device="cpu")
    return (jsmcs.make_tempered_logprobs(jmodel, (), jtr, J_OBS),
            make_tempered_logprobs(model, (), tr, OBS, device="cpu"))


def _points(d, n, seed):
    return np.random.default_rng(seed).standard_normal((n, d)) * 0.8


@pytest.mark.parametrize("name", ["nn", "scale"])
def test_make_tempered_logprobs_matches_reference(name):
    (jprior, jlik, ju0, _, jconstrain), (prior, lik, u0, _, constrain) = \
        _both(name)
    assert u0.shape == ju0.shape
    for u in _points(u0.shape[0], 5, 1):
        np.testing.assert_allclose(float(prior(tensor(u))),
                                   float(jprior(jnp.asarray(u))), **TOL)
        np.testing.assert_allclose(float(lik(tensor(u))),
                                   float(jlik(jnp.asarray(u))), **TOL)
        want, got = jconstrain(jnp.asarray(u)), constrain(tensor(u))
        for addr in want:
            np.testing.assert_allclose(got[addr].numpy(),
                                       np.asarray(want[addr]), **TOL)


def _reference_draws(key, n, d, kind):
    """The draws the reference's move takes for n particles of dimension
    d from ``key`` (smc_sampler.py:84-130): split(key, N), then per
    particle (momentum or noise, accept)."""
    first, acc = [], []
    for k in jax.random.split(key, n):
        k1, k2 = jax.random.split(k)
        first.append(np.asarray(jax.random.normal(k1, (d,), jnp.float64)))
        acc.append(float(jax.random.uniform(k2, (), jnp.float64)))
    return tensor(np.stack(first)), tensor(np.array(acc))


@pytest.mark.parametrize("move", ["hmc", "mala"])
@pytest.mark.parametrize("name", ["nn", "scale"])
def test_tempered_moves_on_reference_draws(move, name):
    (jprior, jlik, ju0, _, _), _ = _both(name)
    model = MODELS[name][0]
    tr, _ = model.generate(0, (), OBS, device="cpu")
    joint_and_lik, u0, _, _ = smcs._tempered_parts(model, (), tr, OBS, None,
                                                   "cpu")
    beta, eps, n = 0.4, 0.3, 12
    u = _points(u0.shape[0], n, 2)

    def jlogdens(ui):
        return jprior(ui) + beta * jlik(ui)

    key = jax.random.PRNGKey(9)
    draws = _reference_draws(key, n, u0.shape[0], move)
    vag = _value_and_grad(smcs.tempered(joint_and_lik, beta))
    # the reference's move compiled once (eager JAX compiles every op)
    if move == "hmc":
        want, j_acc = jax.jit(lambda k, x: jsmcs._tempered_hmc_move(
            k, x, jlogdens, jax.grad(jlogdens), eps, 8))(key, jnp.asarray(u))
        got, acc = smcs._tempered_hmc_move(None, tensor(u), vag, eps, 8,
                                           draws=draws)
    else:
        want, j_acc = jax.jit(lambda k, x: jsmcs._tempered_mala_move(
            k, x, jlogdens, jax.grad(jlogdens), eps))(key, jnp.asarray(u))
        got, acc = smcs._tempered_mala_move(None, tensor(u), vag, eps,
                                            draws=draws)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)


def _reference_pick_delta(lw, ll, beta, target_ess, bisect_iters):
    """adaptive_smc_sampler's pick_delta (smc_sampler.py:279-309), as the
    reference writes it (a closure there)."""
    def ess_of(x):
        return effective_sample_size_from_log_weights(
            x - jax.scipy.special.logsumexp(x))

    hi0 = 1.0 - beta
    floor = target_ess * ess_of(lw)

    def body(i, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        ok = ess_of(lw + mid * ll) >= floor
        return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid))

    lo, _ = jax.lax.fori_loop(0, bisect_iters, body,
                              (jnp.zeros((), lw.dtype), hi0))
    return jnp.where(ess_of(lw + hi0 * ll) >= floor, hi0,
                     jnp.maximum(lo, hi0 * 1e-6))


@pytest.mark.parametrize("scale,beta", [(0.05, 0.2), (3.0, 0.2),
                                        (40.0, 0.9)])
def test_pick_delta_matches_reference(scale, beta):
    rng = np.random.default_rng(5)
    lw = rng.standard_normal(256) * 0.3
    ll = rng.standard_normal(256) * scale
    want = _reference_pick_delta(jnp.asarray(lw), jnp.asarray(ll),
                                 jnp.asarray(beta), 0.9, 30)
    got = smcs._pick_delta(tensor(lw), tensor(ll), torch.tensor(beta), 0.9,
                           30)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("k", [5, 6])
def test_swap_round_matches_reference(parity, k):
    rng = np.random.default_rng(k + parity)
    u = rng.standard_normal((k, 2))
    ll = rng.standard_normal(k) * 3.0
    betas = np.geomspace(0.05, 1.0, k)
    key = jax.random.PRNGKey(k)
    us = np.asarray(jax.random.uniform(key, (k,)))
    ju, jll, jacc = jpt._swap_round(key, jnp.asarray(u), jnp.asarray(ll),
                                    jnp.asarray(betas), parity)
    gu, gll, gacc = _swap_round(None, tensor(u)[None], tensor(ll)[None],
                                tensor(betas), parity, us=tensor(us)[None])
    np.testing.assert_array_equal(gu[0].numpy(), np.asarray(ju))
    np.testing.assert_array_equal(gll[0].numpy(), np.asarray(jll))
    np.testing.assert_array_equal(gacc[0].numpy(), np.asarray(jacc))


def test_iid_lane_form_is_from_standard():
    """iid(normal, 3) under lane keys: lane i's three draws are its own
    standard normals through the base's from_standard, the per-lane mean
    broadcast over the plate; the log-density sums the plate per lane."""
    ks = lanes(2, 5, "cpu")
    mu = torch.arange(5.0)
    x = ys3.sample_lanes(ks, (mu, 0.5))
    z = normal_lanes(ks, (3,), torch.float64)
    assert torch.equal(x, z * 0.5 + mu[:, None])
    lp = ys3.logpdf(x, (mu, 0.5))
    want = normal.logpdf(x, (mu[:, None], 0.5)).sum(-1)
    assert torch.equal(lp, want)
    assert torch.equal(ys3.sample_lanes(lanes(2, 10, "cpu"), (0.0, 1.0))[:5],
                       ys3.sample_lanes(ks, (0.0, 1.0)))


@gen
def spread_model(h):
    m = h.sample(normal, (0.0, 1.0), "m")
    h.sample(ys3, (100.0 * m, 0.01), "ys")
    return m


def test_iid_lane_form_when_the_lanes_equal_the_plate():
    """Three lanes of iid(normal, 3), so a per-lane mean has the plate's
    length: each lane draws around its own mean and is scored against it,
    in sample_lanes, in logpdf and in a simulate under lane keys."""
    ks = lanes(4, 3, "cpu")
    mu = torch.tensor([0.0, 100.0, -100.0])
    x = ys3.sample_lanes(ks, (mu, 0.5))
    z = normal_lanes(ks, (3,), torch.float64)
    assert torch.equal(x, z * 0.5 + mu[:, None])
    want = torch.stack([normal.logpdf(x[i], (mu[i], 0.5)).sum()
                        for i in range(3)])
    assert torch.equal(ys3.logpdf(x, (mu, 0.5)), want)
    # a trace's own x (no lane axis): the mean is per element
    assert torch.equal(ys3.logpdf(x[0], (mu, 0.5)),
                       normal.logpdf(x[0], (mu, 0.5)).sum())
    tr = spread_model.simulate(ks, ())
    m, ys = tr.data.read("m"), tr.data.read("ys")
    assert ys.shape == (3, 3)
    assert bool(((ys - 100.0 * m[:, None]).abs() < 0.1).all())
    want = torch.stack([normal.logpdf(ys[i], (100.0 * m[i], 0.01)).sum()
                        for i in range(3)])
    np.testing.assert_allclose(tr.data.search("ys").weight().numpy(),
                               want.numpy(), **TOL)


def _weighted(out):
    mus = out["particles"]["mu"]
    w = torch.exp(out["log_weights"])
    mean = float((w * mus).sum())
    return mean, float(torch.sqrt((w * (mus - mean) ** 2).sum()))


def test_smc_sampler_posterior_and_log_ml():
    out = smc_sampler(0, nn_model, (), OBS, num_particles=2048, num_temps=16,
                      num_moves=2, move="hmc", step_size=0.3, num_leapfrog=8,
                      device="cpu")
    mean, sd = _weighted(out)
    assert mean == pytest.approx(_POST_MEAN, abs=0.05)
    assert sd == pytest.approx(_POST_STD, abs=0.06)
    assert float(out["log_ml"]) == pytest.approx(_exact_log_ml(), abs=0.15)
    assert float(out["accept_rate"].mean()) > 0.4


def test_smc_sampler_mala_move():
    out = smc_sampler(1, nn_model, (), OBS, num_particles=2048, num_temps=16,
                      num_moves=3, move="mala", step_size=0.3, device="cpu")
    mean, _ = _weighted(out)
    assert mean == pytest.approx(_POST_MEAN, abs=0.07)
    assert float(out["log_ml"]) == pytest.approx(_exact_log_ml(), abs=0.2)


def test_smc_sampler_runs_whole_program():
    """tests/test_smc_sampler.py's jit test: the port has no jit; the whole
    sampler runs at its configuration and gives a finite log-ML."""
    out = smc_sampler(2, nn_model, (), OBS, num_particles=256, num_temps=8,
                      num_moves=1, step_size=0.3, device="cpu")
    assert bool(torch.isfinite(out["log_ml"]))


def test_parallel_tempering_cold_chain_posterior():
    out = parallel_tempering(3, nn_model, (), OBS, num_replicas=6,
                             num_chains=4, num_rounds=400, move="hmc",
                             step_size=0.3, num_leapfrog=8, device="cpu")
    mus = out["samples"]["mu"][:, 100:].reshape(-1)
    assert float(mus.mean()) == pytest.approx(_POST_MEAN, abs=0.06)
    assert float(mus.std()) == pytest.approx(_POST_STD, abs=0.06)
    assert float(out["swap_accept"].double().mean()) > 0.1


def test_adaptive_smc_sampler():
    out = adaptive_smc_sampler(4, nn_model, (), OBS, num_particles=2048,
                               target_ess=0.9, num_moves=2, move="hmc",
                               step_size=0.3, device="cpu")
    nt = out["num_temps"]
    assert 1 < nt < 100
    betas = out["betas"][:nt]
    assert bool((betas.diff() > 0).all())
    assert float(betas[-1]) == pytest.approx(1.0)
    mean, _ = _weighted(out)
    assert mean == pytest.approx(_POST_MEAN, abs=0.05)
    assert float(out["log_ml"]) == pytest.approx(_exact_log_ml(), abs=0.15)
