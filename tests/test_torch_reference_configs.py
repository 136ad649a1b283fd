"""The 17 gates that tier-1 runs shortened (ROADMAP Queue 3), each at the
reference's configuration and bounds, marked ``slow`` (outside tier-1).

The tier-1 versions stay in their files, unchanged; these copies sit beside
them. The file imports nothing of JAX, so it also runs where the JAX
package does not, on the card's machine:

    MODPPL_TORCH_TEST_DEVICE=cuda python -m pytest --noconftest -m slow \\
        tests/test_torch_reference_configs.py

(``--noconftest``: tests/conftest.py imports JAX). Without the variable
the gates run on the CPU. The data the reference simulates with its
threefry streams (the PMMH, particle Gibbs and stochastic-volatility
data) are written out below as the reference's float64 values.
"""

import math
import os

import numpy as np
import pytest
import torch
from scipy.stats import norm as sps_norm

from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import gamma, iid, normal
from modppl_tpu_torch.inference.chees import chees
from modppl_tpu_torch.inference.hmc import hmc, hmc_runner
from modppl_tpu_torch.inference.kalman import kalman_filter, kalman_smoother
from modppl_tpu_torch.inference.nuts import nuts
from modppl_tpu_torch.inference.pgibbs import particle_gibbs
from modppl_tpu_torch.inference.pmcmc import pmmh, smc_log_ml_fn
from modppl_tpu_torch.inference.vsmc import ScanKernel
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.models import gp as tgp
from modppl_tpu_torch.models.hierarchical_static import (
    exact_hierarchical_posterior,
    make_hierarchical_marginalized,
)
from modppl_tpu_torch.models.lgssm import lgssm_scan_kernel, make_lgssm
from modppl_tpu_torch.models.stochvol import (
    SVParams,
    make_stochvol_joint,
    volatility_path,
)
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

DEVICE = os.environ.get("MODPPL_TORCH_TEST_DEVICE", "cpu")

pytestmark = pytest.mark.slow


@pytest.fixture
def float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _np(x):
    return x.double().cpu().numpy()


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")
    return mu


@gen
def normal_scale_model(h):
    scale = h.sample(gamma, (2.0, 1.0), "scale")
    h.sample(iid(normal, 5), (0.0, scale), "ys")


# --------------------------------------------------------------------------
# PR 10: tests/test_hmc_vi.py, test_pooled_adaptation.py,
# test_factor_marginalized.py
# --------------------------------------------------------------------------

def test_hmc_conjugate_posterior():
    """test_hmc_vi.py:51-59: 4 chains, 400 + 800."""
    out = hmc(1, conjugate, (), Trie.from_dict({"x": 1.0}), num_samples=800,
              num_warmup=400, num_chains=4, use_fused_quadratic=False,
              device=DEVICE)
    mus = _np(out["samples"]["mu"]).ravel()
    assert mus.mean() == pytest.approx(0.5, abs=0.05)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
    assert float(out["accept_prob"].mean()) > 0.6
    assert float(out["divergences"].double().mean()) < 0.01


def test_hmc_positive_support():
    """test_hmc_vi.py:62-78: 4 chains, 500 + 1500."""
    ys = np.array([0.5, -1.2, 0.8, 2.0, -0.3])
    out = hmc(2, normal_scale_model, (),
              Trie.from_dict({"ys": torch.tensor(ys, dtype=torch.float32)}),
              num_samples=1500, num_warmup=500, num_chains=4, device=DEVICE)
    scales = _np(out["samples"]["scale"]).ravel()
    assert np.all(scales > 0)
    grid = np.linspace(1e-3, 10.0, 4000)
    logp = (np.log(grid) - grid
            + sum(-0.5 * ((y / grid) ** 2) - np.log(grid) for y in ys))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    assert scales.mean() == pytest.approx(float((grid * w).sum()), abs=0.08)


def test_hmc_runner_reuse():
    """test_hmc_vi.py:137-150: 8 chains, 200 + 400."""
    run = hmc_runner(conjugate, (), Trie.from_dict({"x": 1.0}),
                     num_samples=400, num_warmup=200, num_chains=8,
                     use_fused_quadratic=False, device=DEVICE)
    m1 = _np(run(0)["samples"]["mu"]).ravel()
    m2 = _np(run(1)["samples"]["mu"]).ravel()
    assert not np.array_equal(m1, m2)
    assert m1.mean() == pytest.approx(0.5, abs=0.06)
    assert m2.mean() == pytest.approx(0.5, abs=0.06)


@gen
def pooled_target(h):
    mu = h.sample(normal, (0.0, 3.0), "mu")
    tau = h.sample(normal, (0.0, 0.1), "tau")
    h.sample(iid(normal, 4), (mu + tau, 1.0), "ys")
    return mu


def test_pooled_posterior_correct():
    """test_pooled_adaptation.py:133-144: 8 chains, 300 + 600."""
    obs = Trie.from_dict({"ys": torch.tensor([0.4, 0.6, 0.5, 0.7])})
    out = hmc(11, pooled_target, (), obs, num_samples=600, num_warmup=300,
              num_chains=8, pooled_adaptation=True,
              use_fused_quadratic=False, device=DEVICE)
    var_s = 1.0 / (1.0 / 9.01 + 4.0)
    mean_s = var_s * 4.0 * 0.55
    mus = _np(out["samples"]["mu"]).ravel()
    assert mus.mean() == pytest.approx(mean_s * 9.0 / 9.01, abs=0.06)
    assert float(out["accept_prob"].mean()) > 0.6


def test_hmc_marginalized_hierarchical():
    """test_factor_marginalized.py:63-89: 4 chains, 800 + 1500, L = 24."""
    xs = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
    ys = 0.2 + 0.5 * xs + 0.3 * xs * xs
    p_lin, m_lin, _, m_quad, _, _ = exact_hierarchical_posterior(xs, ys)
    out = hmc(4, make_hierarchical_marginalized(len(xs)),
              (tensor(xs), tensor(ys)), Trie(), num_samples=1500,
              num_warmup=800, num_chains=4, num_leapfrog=24, device=DEVICE)
    s = {k: _np(out["samples"][f"coeffs / {k}"]).ravel() for k in "abc"}
    assert s["a"].mean() == pytest.approx(
        p_lin * m_lin[0] + (1 - p_lin) * m_quad[0], abs=0.05)
    assert s["b"].mean() == pytest.approx(
        p_lin * m_lin[1] + (1 - p_lin) * m_quad[1], abs=0.05)
    assert s["c"].mean() == pytest.approx((1 - p_lin) * m_quad[2], abs=0.08)


# --------------------------------------------------------------------------
# PR 12: tests/test_chees.py, tests/test_gp.py
# --------------------------------------------------------------------------

@gen
def conjugate_half(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 0.5), "x")
    return mu


@pytest.mark.parametrize("static_unroll", [None, 16])
def test_chees_conjugate_posterior(static_unroll):
    """test_chees.py:28-40 / :139-: 32 chains, 300 + 400, the first 100
    samples dropped."""
    out = chees(0, conjugate_half, (), Trie.from_dict({"x": 1.0}),
                num_samples=400, num_warmup=300, num_chains=32,
                static_unroll=static_unroll, device=DEVICE)
    mus = _np(out["samples"]["mu"][:, 100:]).ravel()
    assert abs(mus.mean() - 0.8) < 0.05, mus.mean()
    assert abs(mus.std() - np.sqrt(0.2)) < 0.05, mus.std()
    assert not bool(out["divergences"].any())
    if static_unroll is not None:
        assert int(out["num_leapfrog"].max()) <= static_unroll


def test_gp_hmc_posterior_on_hyperparameters(float64):
    """test_gp.py:100-118: 8 chains, 75 + 150 at L = 8, the second half."""
    model = tgp.make_gp_model(np.linspace(-2.0, 2.0, 12), device=DEVICE)
    sim = Trie.from_dict({"log_amp": 0.0, "log_ls": -0.3, "log_noise": -2.3})
    tr, _ = model.generate(3, (), sim, device=DEVICE)
    out = hmc(0, model, (), Trie.from_dict({"y": tr.data.read("y")}),
              num_samples=150, num_warmup=75, num_chains=8, num_leapfrog=8,
              use_fused_quadratic=False, device=DEVICE)
    assert float(torch.mean(out["accept_prob"])) > 0.5
    assert abs(_np(out["samples"]["log_ls"][:, 75:]).mean() - (-0.3)) < 1.2


# --------------------------------------------------------------------------
# PR 13: tests/test_nuts.py
# --------------------------------------------------------------------------

@gen
def linreg(h, xs):
    slope = h.sample(normal, (0.0, 1.0), "slope")
    intercept = h.sample(normal, (0.0, 2.0), "intercept")
    h.sample(iid(normal, 11), (slope * xs + intercept, 0.1), "ys")


@gen
def funnel(h):
    v = h.sample(normal, (0.0, 3.0), "v")
    h.sample(iid(normal, 4), (0.0, torch.exp(0.5 * v)), "x")


def _linreg():
    xs = np.linspace(-5.0, 5.0, 11)
    ys = 0.5 * xs - 1.0
    X = np.stack([xs, np.ones(11)], 1)
    cov = np.linalg.inv(np.diag([1.0, 0.25]) + 100.0 * X.T @ X)
    return ((tensor(xs),), Trie.from_dict({"ys": tensor(ys)}),
            cov @ (100.0 * X.T @ ys), cov)


def test_nuts_conjugate_posterior(float64):
    """test_nuts.py:18-28: 4 chains, 400 + 800."""
    out = nuts(0, conjugate, (), Trie.from_dict({"x": torch.tensor(1.0)}),
               num_samples=800, num_warmup=400, num_chains=4, max_depth=6,
               device=DEVICE)
    mus = _np(out["samples"]["mu"]).ravel()
    assert mus.mean() == pytest.approx(0.5, abs=0.05)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
    assert float(out["divergences"].double().mean()) < 0.01
    assert float(out["tree_depth"].double().mean()) > 1.0


def test_nuts_linreg_posterior(float64):
    """test_nuts.py:44-58: 4 chains, 500 + 1000."""
    args, obs, mean, cov = _linreg()
    out = nuts(1, linreg, args, obs, num_samples=1000, num_warmup=500,
               num_chains=4, max_depth=8, device=DEVICE)
    s = _np(out["samples"]["slope"]).ravel()
    i = _np(out["samples"]["intercept"]).ravel()
    assert s.mean() == pytest.approx(mean[0], abs=0.005)
    assert i.mean() == pytest.approx(mean[1], abs=0.02)
    assert s.std() == pytest.approx(np.sqrt(cov[0, 0]), rel=0.15)
    assert i.std() == pytest.approx(np.sqrt(cov[1, 1]), rel=0.15)


def test_nuts_funnel_adapted(float64):
    """test_nuts.py:92-98 (part (b) of test_nuts_funnel_divergences): 8
    chains, 800 + 1500, target accept 0.99."""
    out = nuts(3, funnel, (), Trie(), num_samples=1500, num_warmup=800,
               num_chains=8, max_depth=8, target_accept=0.99, device=DEVICE)
    vs = _np(out["samples"]["v"]).ravel()
    assert float(out["divergences"].double().mean()) < 0.1
    assert vs.mean() == pytest.approx(0.0, abs=0.6)
    assert vs.std() == pytest.approx(3.0, rel=0.25)


def test_nuts_matches_hmc_on_correlated_target(float64):
    """test_nuts.py:101-128: 4 chains, 500 + 1000 each."""
    args, obs, mean, cov = _linreg()
    kw = dict(num_samples=1000, num_warmup=500, num_chains=4, device=DEVICE)
    out_n = nuts(4, linreg, args, obs, max_depth=8, **kw)
    out_h = hmc(5, linreg, args, obs, num_leapfrog=16,
                use_fused_quadratic=False, **kw)
    for out in (out_n, out_h):
        samp = np.stack([_np(out["samples"]["slope"]).ravel(),
                         _np(out["samples"]["intercept"]).ravel()], 1)
        np.testing.assert_allclose(samp.mean(0), mean, atol=0.02)
        np.testing.assert_allclose(np.cov(samp.T), cov, atol=2e-4)
    s_n = _np(out_n["samples"]["slope"]).ravel()
    for q in (0.05, 0.25, 0.5, 0.75, 0.95):
        want = mean[0] + np.sqrt(cov[0, 0]) * sps_norm.ppf(q)
        assert np.quantile(s_n, q) == pytest.approx(want, abs=3e-3), q


def test_nuts_pooled_matches_per_chain_statistically(float64):
    """test_nuts.py:131-148: 8 chains, 300 + 600 each."""
    obs = Trie.from_dict({"x": torch.tensor(1.0)})
    kw = dict(num_samples=600, num_warmup=300, num_chains=8, max_depth=6,
              device=DEVICE)
    pooled = nuts(6, conjugate, (), obs, pooled_adaptation=True, **kw)
    per = nuts(7, conjugate, (), obs, pooled_adaptation=False, **kw)
    mp = _np(pooled["samples"]["mu"]).ravel()
    mq = _np(per["samples"]["mu"]).ravel()
    assert mp.mean() == pytest.approx(0.5, abs=0.05)
    assert mq.mean() == pytest.approx(0.5, abs=0.05)
    assert mp.std() == pytest.approx(np.sqrt(0.5), abs=0.05)


# --------------------------------------------------------------------------
# PR 14: tests/test_stochvol.py, test_pmcmc.py, test_pgibbs.py
# --------------------------------------------------------------------------

# tests/test_stochvol.py's path: the reference's _simulate at
# jax.random.PRNGKey(0), T = 32, SVParams(mu=-1.0, phi=0.9, sigma=0.8)
SV_H = (2.450467500613033, 1.7204487715910721, 1.7807696781433597,
        3.408164772895463, 2.5070546555742457, 1.8599143629302644,
        1.624604969130227, 0.9938106099427895, -0.4583469923232412,
        -0.27837986065446746, 1.0034667076105113, 1.5946406758835385,
        1.9882222367971614, 0.9513826121041069, 0.4973035802778081,
        0.9365579957156973, 1.5079676080458835, 0.9523330207275948,
        1.3313546239470921, 2.2605113752412436, 0.6203088811311456,
        0.4228075820507398, -0.20089081844563553, 0.3685104291951086,
        -0.10741055368917324, 0.9112492389252177, 0.2457336075162167,
        -0.8220712521813771, -0.3988149599500935, 0.07246878573007015,
        -0.2788282907973803, -0.6257680504416362)
SV_Y = (-4.769956997373821, 3.3851482604080068, 1.5220806960257083,
        1.1019461793155363, 0.865678074892664, 1.3292351093315586,
        1.9418673853301738, 2.0113301091892737, -1.1375639116813145,
        0.9918765940601046, -1.2386202088237912, 0.8938732858670723,
        -1.4777291597507358, 0.6620504313581811, 0.42337850121919035,
        -0.15244374677407976, 1.9403161248477927, 0.6259046368373151,
        3.7588105619972803, 4.9334877420286105, 1.8997077700614033,
        0.16887057390495483, 0.7077827471575772, 0.4770342761385889,
        0.6774748831037057, 3.6036612154332874, 0.37522561172581814,
        0.915227411841168, 0.44537198434110564, 0.9773616230814491,
        -0.18830505185208604, -0.38077565883596)


def test_stochvol_joint_hmc_recovers_path(float64):
    """test_stochvol.py:100-127: 16 chains, 300 + 400 at L = 16, the last
    200 kept."""
    T, params = 32, SVParams(mu=-1.0, phi=0.9, sigma=0.8)
    ys = tensor(np.asarray(SV_Y))
    model = make_stochvol_joint(T, params)
    out = hmc(2, model, (ys,), Trie(), num_samples=400, num_warmup=300,
              num_chains=16, num_leapfrog=16, device=DEVICE)
    acc = float(torch.mean(torch.as_tensor(out["accept_prob"])))
    assert 0.5 < acc < 0.99, acc
    zs = out["samples"]["z"][:, 200:]
    h_mean = _np(volatility_path(zs, params).reshape(-1, T).mean(0))
    corr = np.corrcoef(h_mean, np.asarray(SV_H))[0, 1]
    assert corr > 0.4, corr
    assert np.all(np.abs(h_mean - params.mu) < 4.0)


# tests/test_pmcmc.py's data: the reference's simulation at a = 0.7
PMMH_YS = (1.8543003223768244, 1.8803144089710702, 1.102049900121674,
           -1.0271285071015643, -0.9514388130130933, -1.7638284387600267,
           -1.0782675411112455, -0.4312744368291923, -0.4602346485465222,
           -0.0508029016176299)


def test_pmmh_recovers_transition_coefficient(float64):
    """test_pmcmc.py:38-63: 2 chains x 1200, 300 burn-in, 256 particles,
    step 0.15."""
    q, r = math.sqrt(0.2), math.sqrt(0.3)

    def make_kernel(a):
        @gen
        def init(h, _s0):
            x = h.sample(normal, (0.0, 1.0), "x")
            h.sample(normal, (x, r), "obs")
            return x

        @gen
        def step(h, t, prev):
            x = h.sample(normal, (a * prev, q), "x")
            h.sample(normal, (x, r), "obs")
            return x

        return ScanKernel(init, step)

    ys = tensor(np.asarray(PMMH_YS))
    grid = np.linspace(-0.99, 0.99, 397)
    lml = np.array([float(kalman_filter(
        make_lgssm([[a]], [[0.2]], [[1.0]], [[0.3]], [0.0], [[1.0]],
                   device="cpu"), ys[:, None], device="cpu")["log_ml"])
        for a in grid])
    w = np.exp(lml - lml.max())
    exact_mean = float((grid * w).sum() / w.sum())
    fn = smc_log_ml_fn(make_kernel, torch.zeros(()),
                       Trie.from_dict({"obs": ys[0]}),
                       Trie.from_dict({"obs": ys[1:]}), 256, device=DEVICE)
    out = pmmh(1, lambda a: torch.where(a.abs() < 0.99, 0.0, -math.inf), fn,
               torch.tensor(0.2), num_samples=1200, num_chains=2,
               step_size=0.15, device=DEVICE)
    pm_mean = float(out["samples"][:, 300:].double().mean())
    accept = out["accept_rate"]
    assert 0.05 < float(accept.min()) and float(accept.max()) < 0.9, accept
    assert abs(pm_mean - exact_mean) < 0.07, (pm_mean, exact_mean)


# tests/test_pgibbs.py's data: the reference's simulation, T = 6
PG_YS = (1.8503199439657134, 2.1464795067452846, 1.3390485880315648,
         -1.172697507620736, -1.2052736789001608, -2.2882498495022094)


def _pg_setup():
    params = make_lgssm([[0.8]], [[0.3]], [[1.0]], [[0.4]], [0.0], [[1.0]],
                        device=DEVICE)
    ys = tensor(np.asarray(PG_YS))[:, None]
    smth = kalman_smoother(make_lgssm([[0.8]], [[0.3]], [[1.0]], [[0.4]],
                                      [0.0], [[1.0]], device="cpu"), ys,
                           device="cpu")
    return (lgssm_scan_kernel(params), Trie.from_dict({"obs": ys[0]}),
            Trie.from_dict({"obs": ys[1:]}), smth)


def test_particle_gibbs_matches_kalman_smoother(float64):
    """test_pgibbs.py:34-51: 1500 sweeps, 300 burn-in, N = 32."""
    kernel, ic, sc, smth = _pg_setup()
    out = particle_gibbs(1, kernel, torch.zeros(1), ic, sc,
                         latent_init_addrs=("x",), latent_step_addrs=("x",),
                         num_particles=32, num_sweeps=1500, device=DEVICE)
    xs0 = _np(out["init"]["x"][300:, 0])
    xs_rest = _np(out["steps"]["x"][300:, :, 0])
    traj = np.concatenate([xs0[:, None], xs_rest], axis=1)
    exact_means = _np(smth["means"])[:, 0]
    exact_sds = np.sqrt(_np(smth["covs"])[:, 0, 0])
    np.testing.assert_allclose(traj.mean(axis=0), exact_means, atol=0.12)
    np.testing.assert_allclose(traj.std(axis=0), exact_sds, atol=0.12)


def test_particle_gibbs_without_ancestor_sampling(float64):
    """test_pgibbs.py:54-64: 1500 sweeps, 300 burn-in, N = 64."""
    kernel, ic, sc, smth = _pg_setup()
    out = particle_gibbs(3, kernel, torch.zeros(1), ic, sc,
                         latent_init_addrs=("x",), latent_step_addrs=("x",),
                         num_particles=64, num_sweeps=1500,
                         ancestor_sampling=False, device=DEVICE)
    xT = _np(out["steps"]["x"][300:, -1, 0])
    assert abs(xT.mean() - float(smth["means"][-1, 0])) < 0.12
