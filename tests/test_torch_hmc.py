"""The port's HMC path and what it stands on, port vs reference (CPU).

Distributions, bijectors, the warmup schedule, the unconstrained
log-density, the flat coordinate order and quadratic-target detection are
held to the JAX package on the same inputs; ``hmc_runner`` is held to the
exact posteriors, as the reference's own tests hold it
(tests/test_leapfrog_pallas.py:306-380). Inputs are made with numpy from a
seed; float64 unless the reference's model fixes float32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from modppl_tpu import Trie as JTrie
from modppl_tpu.dists import bernoulli as j_bernoulli
from modppl_tpu.dists import mvnormal as j_mvnormal
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.dists.iid import iid as j_iid
from modppl_tpu.inference import transforms as jtr
from modppl_tpu.inference.adaptation import warmup_schedule as j_schedule
from modppl_tpu.inference.hmc import (
    da_init as j_da_init,
    da_update as j_da_update,
    detect_quadratic_target as j_detect,
    make_unconstrained_logprob as j_make_logprob,
)
from modppl_tpu.models.hierarchical_static import (
    make_hierarchical_static as j_make_hier,
)
from modppl_tpu.models.illcond_gauss import make_illcond_gauss as j_make_illcond
from modppl_tpu.modeling import gen as j_gen
from modppl_tpu.utils.diagnostics import ess_autocorr as j_ess
from modppl_tpu.utils.diagnostics import split_rhat as j_rhat
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import bernoulli, iid, mvnormal, normal
from modppl_tpu_torch.inference import transforms as ttr
from modppl_tpu_torch.inference.adaptation import warmup_schedule
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.models.hierarchical_static import (
    NOISE,
    exact_hierarchical_posterior,
    make_hierarchical_static,
)
from modppl_tpu_torch.models.illcond_gauss import illcond_cov, make_illcond_gauss
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.utils.diagnostics import ess_autocorr, split_rhat
from _torch_threads import one_thread  # noqa: F401

# the package exports the functions hmc and nuts; the modules by path
thmc = importlib.import_module("modppl_tpu_torch.inference.hmc")

TOL = dict(rtol=1e-9, atol=1e-9)


def _hier_data(n=10):
    xs = np.linspace(-1.0, 1.0, n)
    ys = (0.3 + 0.5 * xs - 0.8 * xs * xs
          + NOISE * np.random.default_rng(0).standard_normal(n))
    return xs, ys


def _hier_both():
    """The hierarchical leg's model, data and observations on both sides."""
    xs, ys = _hier_data()
    j = (j_make_hier(10), (jnp.asarray(xs),),
         JTrie.from_dict({"ys": jnp.asarray(ys), "is_linear": False}))
    t = (make_hierarchical_static(10), (tensor(xs),),
         Trie.from_dict({"ys": tensor(ys), "is_linear": False}))
    return j, t


def _port_logprob(model, args, obs, device="cpu"):
    tr, _ = model.generate(0, args, obs, device=device)
    lp, u0, bij, _ = thmc.make_unconstrained_logprob(model, args, tr, obs,
                                                     device=device)
    flat, unravel = thmc.ravel_latents(u0)
    return (lambda u: lp(unravel(u))), flat, bij


def _jax_logprob(model, args, obs):
    tr, _ = model.generate(jax.random.PRNGKey(0), args, obs)
    lp, u0, bij, _ = j_make_logprob(model, args, tr, obs)
    flat, unravel = ravel_pytree(u0)
    return (lambda u: lp(unravel(u))), flat, bij


# --------------------------------------------------------------------------
# distributions, bijectors, schedule
# --------------------------------------------------------------------------

def test_bernoulli_and_iid_logpdf_match_reference():
    for x in (True, False):
        assert bernoulli.logpdf(x, 0.7) == pytest.approx(
            float(j_bernoulli.logpdf(x, 0.7)), rel=1e-12)
    xs = np.array([True, False, True])
    np.testing.assert_allclose(
        bernoulli.logpdf(torch.tensor(xs), tensor(np.array(0.3))).numpy(),
        np.asarray(j_bernoulli.logpdf(jnp.asarray(xs), 0.3)), **TOL)
    assert bernoulli.is_discrete and bernoulli.support == "discrete"
    rng = np.random.default_rng(1)
    x, mean = rng.standard_normal(7), rng.standard_normal(7)
    for params in ((tensor(mean), 0.4), (0.2, 1.3)):
        jparams = tuple(jnp.asarray(p.numpy()) if torch.is_tensor(p) else p
                        for p in params)
        np.testing.assert_allclose(
            float(iid(normal, 7).logpdf(tensor(x), params)),
            float(j_iid(j_normal, 7).logpdf(jnp.asarray(x), jparams)), **TOL)
    draws = iid(normal, 5).sample(torch.Generator().manual_seed(0), (0.0, 1.0),
                                  dtype=torch.float64)
    assert draws.shape == (5,)


@pytest.mark.parametrize("k", [5, 40])
def test_mvnormal_logpdf_matches_reference_both_arms(k):
    """k = 40 takes the port's torch.linalg arm (above SMALL_DIM_MAX = 32)."""
    rng = np.random.default_rng(k)
    a = rng.standard_normal((k, k))
    cov = a @ a.T / k + np.eye(k)
    mu, x = rng.standard_normal(k), rng.standard_normal((3, k))
    got = mvnormal.logpdf(tensor(x), (tensor(mu), tensor(cov)))
    # the reference's large-k arm takes one point at a time
    want = [float(j_mvnormal.logpdf(jnp.asarray(xi), (jnp.asarray(mu),
                                                      jnp.asarray(cov))))
            for xi in x]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    z = mvnormal.sample(torch.Generator().manual_seed(0),
                        (tensor(mu), tensor(cov)))
    assert z.shape == (k,) and bool(torch.isfinite(z).all())


@pytest.mark.parametrize("name", ["IDENTITY", "EXP", "SIGMOID"])
def test_bijectors_match_reference(name):
    u = np.random.default_rng(2).standard_normal(6)
    tb, jb = getattr(ttr, name), getattr(jtr, name)
    x = tb.forward(tensor(u))
    np.testing.assert_allclose(x.numpy(), np.asarray(jb.forward(u)), **TOL)
    np.testing.assert_allclose(tb.inverse(x).numpy(), u, **TOL)
    np.testing.assert_allclose(float(tb.log_det_jacobian(tensor(u))),
                               float(jb.log_det_jacobian(jnp.asarray(u))),
                               **TOL)
    ti, ji = ttr.Interval(-1.0, 3.0), jtr.Interval(-1.0, 3.0)
    np.testing.assert_allclose(ti.forward(tensor(u)).numpy(),
                               np.asarray(ji.forward(u)), **TOL)
    np.testing.assert_allclose(float(ti.log_det_jacobian(tensor(u))),
                               float(ji.log_det_jacobian(jnp.asarray(u))),
                               **TOL)
    assert ttr.transform_for(normal) is ttr.IDENTITY
    assert ttr.transform_for(bernoulli) is None


def test_dual_averaging_matches_reference():
    j_st = j_da_init(jnp.asarray(0.1))
    t_st = thmc.da_init(torch.tensor(0.1, dtype=torch.float64))
    for a in np.random.default_rng(4).random(20):
        j_st = j_da_update(j_st, a)
        t_st = thmc.da_update(t_st, a)
    for k in j_st:
        np.testing.assert_allclose(float(t_st[k]), float(j_st[k]), **TOL)


def test_diagnostics_match_reference():
    rng = np.random.default_rng(5)
    # AR(1) chains, so the autocorrelation sum is non-trivial
    x = np.zeros((4, 300))
    for t in range(1, 300):
        x[:, t] = 0.7 * x[:, t - 1] + rng.standard_normal(4)
    assert ess_autocorr(x) == pytest.approx(j_ess(x), rel=1e-12)
    assert 50 < ess_autocorr(x) < 1200
    np.testing.assert_allclose(split_rhat(x[..., None]),
                               j_rhat(x[..., None]), rtol=1e-12)


def test_warmup_schedule_matches_reference():
    for n in (0, 5, 19, 20, 60, 100, 150, 299, 300, 1000, 4321):
        assert warmup_schedule(n) == j_schedule(n), n


# --------------------------------------------------------------------------
# the unconstrained log-density and its flat coordinates
# --------------------------------------------------------------------------

def test_flat_coordinate_order_is_ravel_pytree():
    """Dict keys in sorted order, whatever order they were made in."""
    vals = {"z": np.array(1.0), "coeffs / b": np.array([2.0, 3.0]),
            "a": np.array([[4.0], [5.0]])}
    flat, unravel = thmc.ravel_latents({k: tensor(v) for k, v in vals.items()})
    want, _ = ravel_pytree({k: jnp.asarray(v) for k, v in vals.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(torch.stack([flat, 2 * flat]))
    assert back["a"].shape == (2, 2, 1) and back["z"].shape == (2,)
    np.testing.assert_array_equal(back["coeffs / b"][1].numpy(), [4.0, 6.0])


def test_unconstrained_logprob_matches_reference():
    (jm, ja, jo), (tm, ta, to) = _hier_both()
    j_lp, j_u0, j_bij = _jax_logprob(jm, ja, jo)
    t_lp, t_u0, t_bij = _port_logprob(tm, ta, to)
    assert list(t_bij) == list(j_bij) == [
        "coeffs / a", "coeffs / b", "coeffs / c"]
    rng = np.random.default_rng(3)
    for u in rng.standard_normal((5, 3)) * 2.0:
        np.testing.assert_allclose(float(t_lp(tensor(u))),
                                   float(j_lp(jnp.asarray(u))), **TOL)


def test_detect_quadratic_matches_reference():
    """(Λ, b) of both legs' models, against the reference's detection: the
    hierarchical target in float64, the Gaussian in the float32 its model
    fixes (d = 16 here, cond 100)."""
    (jm, ja, jo), (tm, ta, to) = _hier_both()
    j_lp, _, _ = _jax_logprob(jm, ja, jo)
    t_lp, flat, _ = _port_logprob(tm, ta, to)
    j_lam, j_b = j_detect(j_lp, 3, jnp.float64)
    lam, b = thmc.detect_quadratic_target(t_lp, 3, flat.dtype,
                                          device="cpu")
    np.testing.assert_allclose(lam.numpy(), np.asarray(j_lam), **TOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(j_b), **TOL)

    d = 16
    j_lp, _, _ = _jax_logprob(j_make_illcond(d, 100.0, 1), (), JTrie())
    t_lp, flat, _ = _port_logprob(make_illcond_gauss(d, 100.0, 1), (), Trie())
    assert flat.dtype == torch.float32
    j_lam, j_b = j_detect(j_lp, d, jnp.float32)
    lam, b = thmc.detect_quadratic_target(t_lp, d, flat.dtype,
                                          device="cpu")
    scale = np.abs(np.asarray(j_lam)).max()
    np.testing.assert_allclose(lam.numpy(), np.asarray(j_lam),
                               atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(j_b), atol=1e-5)
    prec = np.linalg.inv(illcond_cov(d, 100.0, 1).astype(np.float64))
    np.testing.assert_allclose(lam.numpy(), prec, atol=1e-4 * scale)


def _nonquadratic():
    @gen
    def scaled(h):
        s = h.sample(normal, (0.0, 1.0), "log_scale")
        h.sample(iid(normal, 3), (0.0, torch.exp(s)), "ys")

    @j_gen
    def j_scaled(h):
        s = h.sample(j_normal, (0.0, 1.0), "log_scale")
        h.sample(j_iid(j_normal, 3), (0.0, jnp.exp(s)), "ys")

    ys = np.array([0.5, -0.2, 0.1])
    return ((scaled, Trie.from_dict({"ys": tensor(ys)})),
            (j_scaled, JTrie.from_dict({"ys": jnp.asarray(ys)})))


def test_detect_quadratic_none_for_nonquadratic():
    (tm, to), (jm, jo) = _nonquadratic()
    t_lp, flat, _ = _port_logprob(tm, (), to)
    j_lp, _, _ = _jax_logprob(jm, (), jo)
    assert j_detect(j_lp, 1, jnp.float64) is None
    assert thmc.detect_quadratic_target(t_lp, 1, flat.dtype,
                                        device="cpu") is None
    # the runner then takes the generic path
    run = thmc.hmc_runner(tm, (), to, num_samples=5, num_warmup=20,
                          num_chains=4, num_leapfrog=4, device="cpu")
    assert run.quadratic is None
    out = run(0)
    assert out["fused_quadratic"] is False and bool(out["quad_check_ok"])
    assert out["unconstrained"].shape == (4, 5, 1)
    assert bool(torch.isfinite(out["unconstrained"]).all())


# --------------------------------------------------------------------------
# hmc_runner end to end (CPU)
# --------------------------------------------------------------------------

def test_hmc_hierarchical_posterior_means():
    _, (tm, ta, to) = _hier_both()
    xs, ys = _hier_data()
    out = thmc.hmc(0, tm, ta, to, num_samples=300, num_warmup=200,
                   num_chains=256, num_leapfrog=8, device="cpu")
    assert out["fused_quadratic"] and bool(out["quad_check_ok"])
    _, _, _, mean, cov, _ = exact_hierarchical_posterior(xs, ys)
    for i, addr in enumerate(("coeffs / a", "coeffs / b", "coeffs / c")):
        s = out["samples"][addr].numpy()
        assert s.shape == (256, 300)
        assert s.mean() == pytest.approx(mean[i], abs=0.03), addr
        assert s.std() == pytest.approx(np.sqrt(cov[i, i]), rel=0.3), addr
    assert float(out["accept_prob"].mean()) > 0.6
    assert not bool(out["divergences"].any())


def test_hmc_illcond_d8_variances():
    """tests/test_leapfrog_pallas.py:306-324 on the port (d = 8 takes the
    d <= 12 kernels' plain versions)."""
    d = 8
    cov = illcond_cov(d, 50.0, 3).astype(np.float64)
    out = thmc.hmc(0, make_illcond_gauss(d, cond=50.0, seed=3), (), Trie(),
                   num_samples=400, num_warmup=150, num_chains=64,
                   num_leapfrog=12, device="cpu")
    us = out["unconstrained"].numpy().reshape(-1, d)
    np.testing.assert_allclose(us.mean(0), np.zeros(d), atol=0.05)
    np.testing.assert_allclose(us.var(0), np.diag(cov), rtol=0.15)
    assert 0.5 < float(out["accept_prob"].mean()) <= 1.0


def _conjugate():
    @gen
    def conjugate(h, x0):
        mu = h.sample(normal, (x0, 1.0), "mu")
        h.sample(normal, (mu, 0.5), "x")
        return mu

    return conjugate, (torch.zeros((), dtype=torch.float64),), \
        Trie.from_dict({"x": torch.tensor(1.0, dtype=torch.float64)})


def test_quad_check_passes_on_true_quadratic():
    model, args, obs = _conjugate()
    out = thmc.hmc(0, model, args, obs, num_samples=40, num_warmup=60,
                   num_chains=8, device="cpu")
    assert bool(out["quad_check_ok"])
    assert float(out["quad_check_max_dev"]) < 1e-3


def test_quad_check_catches_wrong_dispatch(monkeypatch):
    """A wrong quadratic form (standing in for a target quadratic at the
    probes only) makes the re-scored draws disagree with the generic
    log-joint by a non-constant amount (test_leapfrog_pallas.py:348-380)."""
    real = thmc.detect_quadratic_target

    def wrong(*a, **kw):
        lam, b = real(*a, **kw)
        return 2.5 * lam, b

    monkeypatch.setattr(thmc, "detect_quadratic_target", wrong)
    model, args, obs = _conjugate()
    out = thmc.hmc(0, model, args, obs, num_samples=40, num_warmup=60,
                   num_chains=8, device="cpu")
    assert not bool(out["quad_check_ok"])
    assert float(out["quad_check_max_dev"]) > 1e-2


def test_zero_warmup_raises_not_ported():
    """Automatic dispatch with num_warmup=0 takes the generic path, as the
    reference does (no chunk kernel can run a zero-length warmup): no
    detection, and the chains sample at the unadapted step size and unit
    mass."""
    model, args, obs = _conjugate()
    run = thmc.hmc_runner(model, args, obs, num_samples=6, num_warmup=0,
                          num_chains=4, num_leapfrog=4, device="cpu")
    assert run.quadratic is None
    out = run(0)
    assert out["fused_quadratic"] is False and bool(out["quad_check_ok"])
    assert float(out["step_size"]) == pytest.approx(0.1, rel=1e-12)
    assert torch.equal(out["inv_mass"], torch.ones(1, dtype=torch.float64))
    assert out["samples"]["mu"].shape == (4, 6)


def test_explicit_fused_request_with_zero_warmup_raises():
    """use_fused_quadratic=True with num_warmup=0: both packages detect the
    quadratic target, then raise ValueError when the run starts
    (modppl_tpu/inference/hmc.py _quadratic_chains), rather than take the
    generic path."""
    from modppl_tpu.inference.hmc import hmc_runner as j_hmc_runner

    @j_gen
    def j_conjugate(h):
        mu = h.sample(j_normal, (0.0, 1.0), "mu")
        h.sample(j_normal, (mu, 0.5), "x")
        return mu

    j_run = j_hmc_runner(j_conjugate, (), JTrie.from_dict({"x": 1.0}),
                         num_samples=10, num_warmup=0, num_chains=4,
                         use_fused_quadratic=True)
    with pytest.raises(ValueError, match="num_warmup >= 1"):
        j_run(jax.random.PRNGKey(0))
    model, args, obs = _conjugate()
    run = thmc.hmc_runner(model, args, obs, num_samples=10, num_warmup=0,
                          num_chains=4, use_fused_quadratic=True,
                          device="cpu")
    assert run.quadratic is not None
    with pytest.raises(ValueError, match="num_warmup >= 1"):
        run(0)


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    """With no CUDA device, hmc_runner's default device raises instead of
    running on the CPU; a model without tensor arguments needs a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make_illcond_gauss(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thmc.hmc_runner(model, (), Trie(), num_chains=4)
    with pytest.raises(ValueError, match="device="):
        model.generate(0, (), Trie())
    # quadratic detection runs on the card unless told otherwise
    with pytest.raises((RuntimeError, AssertionError)):
        thmc.detect_quadratic_target(lambda u: -(u * u).sum(), 2)
    tr, _ = model.generate(0, (), Trie(), device="cpu")
    assert tr.data.read("x").device.type == "cpu"
    assert tr.data.search("x").dist is mvnormal
