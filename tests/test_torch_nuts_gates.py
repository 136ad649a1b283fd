"""NUTS on the port: ``tests/test_nuts.py``'s five gates at its bounds, on
the CPU, with the runner's entry points, and chain i's draws at C and 2C.

The port's generic path costs ~2-8 ms of host time a value-and-grad call
on the CPU, whatever the chain count, so the gates run more chains for
fewer iterations than the reference does (listed in ROADMAP Queue 3 with
the reference's configurations); the bounds are the reference's.
"""

import functools
import importlib
import math

import numpy as np
import pytest
import torch
from scipy.stats import norm as sps_norm

from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.hmc import hmc
from modppl_tpu_torch.inference.nuts import nuts, nuts_runner
from modppl_tpu_torch.interop import tensor

from test_torch_nuts import _linreg_data, conjugate, funnel, linreg
from _torch_threads import one_thread  # noqa: F401

# the package exports the functions hmc and nuts; the modules by path
nuts_mod = importlib.import_module("modppl_tpu_torch.inference.nuts")


@pytest.fixture(autouse=True)
def _float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _conj_obs():
    return Trie.from_dict({"x": torch.tensor(1.0)})


def _linreg_inputs():
    xs, ys = _linreg_data()
    return (tensor(xs),), Trie.from_dict({"ys": tensor(ys)})


def _linreg_posterior():
    xs, ys = _linreg_data()
    X = np.stack([xs, np.ones(11)], 1)
    cov = np.linalg.inv(np.diag([1.0, 0.25]) + 100.0 * X.T @ X)
    return cov @ (100.0 * X.T @ ys), cov


def test_nuts_conjugate_posterior():
    # reference: 4 chains, 400 + 800
    out = nuts(0, conjugate, (), _conj_obs(), num_samples=200,
               num_warmup=200, num_chains=32, max_depth=6, device="cpu")
    mus = out["samples"]["mu"].numpy().ravel()
    assert mus.mean() == pytest.approx(0.5, abs=0.05)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
    assert float(out["divergences"].double().mean()) < 0.01
    assert float(out["tree_depth"].double().mean()) > 1.0


def test_nuts_linreg_posterior():
    # reference: 4 chains, 500 + 1000
    args, obs = _linreg_inputs()
    out = nuts(1, linreg, args, obs, num_samples=200, num_warmup=200,
               num_chains=32, max_depth=8, device="cpu")
    s = out["samples"]["slope"].numpy().ravel()
    i = out["samples"]["intercept"].numpy().ravel()
    mean, cov = _linreg_posterior()
    assert s.mean() == pytest.approx(mean[0], abs=0.005)
    assert i.mean() == pytest.approx(mean[1], abs=0.02)
    assert s.std() == pytest.approx(np.sqrt(cov[0, 0]), rel=0.15)
    assert i.std() == pytest.approx(np.sqrt(cov[1, 1]), rel=0.15)


def test_nuts_funnel_divergences_at_a_coarse_step():
    # the reference's configuration (8 chains, 0 + 150, step 1.5)
    out = nuts(2, funnel, (), Trie(), num_samples=150, num_warmup=0,
               num_chains=8, step_size=1.5, max_depth=6, device="cpu")
    assert float(out["divergences"].double().mean()) > 0.02


def test_nuts_matches_hmc_on_correlated_target():
    # reference: 4 chains, 500 + 1000 each
    args, obs = _linreg_inputs()
    kw = dict(num_samples=200, num_warmup=200, num_chains=32, device="cpu")
    out_n = nuts(4, linreg, args, obs, max_depth=8, **kw)
    out_h = hmc(5, linreg, args, obs, num_leapfrog=16,
                use_fused_quadratic=False, **kw)
    mean, cov = _linreg_posterior()
    for out in (out_n, out_h):
        samp = np.stack([out["samples"]["slope"].numpy().ravel(),
                         out["samples"]["intercept"].numpy().ravel()], 1)
        np.testing.assert_allclose(samp.mean(0), mean, atol=0.02)
        np.testing.assert_allclose(np.cov(samp.T), cov, atol=2e-4)
    s_n = out_n["samples"]["slope"].numpy().ravel()
    for q in (0.05, 0.25, 0.5, 0.75, 0.95):
        want = mean[0] + np.sqrt(cov[0, 0]) * sps_norm.ppf(q)
        assert np.quantile(s_n, q) == pytest.approx(want, abs=3e-3), q


def test_nuts_pooled_matches_per_chain_statistically():
    # reference: 8 chains, 300 + 600 each
    kw = dict(num_samples=150, num_warmup=150, num_chains=32, max_depth=6,
              device="cpu")
    pooled = nuts(6, conjugate, (), _conj_obs(), pooled_adaptation=True, **kw)
    per = nuts(7, conjugate, (), _conj_obs(), pooled_adaptation=False, **kw)
    mp = pooled["samples"]["mu"].numpy().ravel()
    mq = per["samples"]["mu"].numpy().ravel()
    assert mp.mean() == pytest.approx(0.5, abs=0.05)
    assert mq.mean() == pytest.approx(0.5, abs=0.05)
    assert mp.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
    assert per["step_size"].shape == (32,)


def test_per_chain_nuts_gives_chain_i_the_same_draws_at_c_and_2c():
    """The property the lane streams exist for: on the per-chain path chain
    i's whole run depends on its key alone, bitwise."""
    outs = []
    for c in (6, 12):
        run = nuts_runner(conjugate, (), _conj_obs(), num_samples=15,
                          num_warmup=25, num_chains=c, max_depth=5,
                          pooled_adaptation=False, device="cpu")
        outs.append(run(3))
    small, big = outs
    for k in ("unconstrained", "logp", "accept_prob", "divergences",
              "tree_depth", "step_size"):
        assert torch.equal(big[k][:6], small[k]), k


def test_early_stop_reads_change_only_the_leaf_count(monkeypatch):
    kw = dict(num_samples=10, num_warmup=20, num_chains=8, max_depth=6,
              device="cpu")
    runs = [nuts_runner(conjugate, (), _conj_obs(), **kw) for _ in range(2)]
    a = runs[0](1)
    monkeypatch.setattr(nuts_mod, "nuts_transition", functools.partial(
        nuts_mod.nuts_transition, _early_stop=False))
    b = runs[1](1)
    for k in ("unconstrained", "logp", "accept_prob", "tree_depth"):
        assert torch.equal(a[k], b[k]), k
    transitions = 30
    assert runs[1].chains.leaves == transitions * (2 ** 6 - 1)
    assert runs[0].chains.leaves < runs[1].chains.leaves
    assert math.isfinite(float(a["step_size"]))


def test_runner_refuses_axis_name_and_needs_a_card_by_default(monkeypatch):
    run = nuts_runner(conjugate, (), _conj_obs(), axis_name="chains",
                      device="cpu", num_warmup=5, num_samples=2)
    with pytest.raises(RuntimeError, match="outside a mesh"):
        run(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nuts_runner(conjugate, (), _conj_obs())
