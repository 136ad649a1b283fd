"""The reference's statistical gates for HMC, on the port's generic path
(CPU).

Counterparts of tests/test_hmc_vi.py's HMC tests (conjugate posterior,
positive support, discrete latents, runner reuse) and of
tests/test_pooled_adaptation.py:113-202 (pooled adaptation reaches the
target accept rate faster, leaves the posterior correct, shapes, the
dual-averaging equilibrium on a stiff target, mass adaptation far from the
origin in float32), with the reference's bounds. The reference runs these
on the CPU through its generic path; targets the port would detect as
quadratic pass ``use_fused_quadratic=False`` so they run it too. Where the
reference runs a few chains for many iterations, these run more chains for
fewer: the generic path's host cost is per batched call, not per chain.
"""

import numpy as np
import pytest
import torch

from modppl_tpu_torch.core.keys import generator
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import bernoulli, gamma, iid, normal
from modppl_tpu_torch.inference.adaptation import run_warmup_pooled
from modppl_tpu_torch.inference.hmc import _pooled_chains, hmc, hmc_runner
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

GENERIC = dict(use_fused_quadratic=False, device="cpu")


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")
    return mu


ys5 = iid(normal, 5)


@gen
def normal_scale_model(h):
    # a positive-support latent: the Exp bijector
    scale = h.sample(gamma, (2.0, 1.0), "scale")
    h.sample(ys5, (0.0, scale), "ys")


# --------------------------------------------------------------------------
# tests/test_hmc_vi.py
# --------------------------------------------------------------------------

def test_hmc_conjugate_posterior():
    """test_hmc_vi.py:51-59 (4 chains, 400 + 800 there)."""
    out = hmc(1, conjugate, (), Trie.from_dict({"x": 1.0}), num_samples=100,
              num_warmup=150, num_chains=32, **GENERIC)
    assert out["fused_quadratic"] is False
    mus = out["samples"]["mu"].double().numpy().ravel()
    assert mus.mean() == pytest.approx(0.5, abs=0.05)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
    assert float(out["accept_prob"].mean()) > 0.6
    assert float(out["divergences"].double().mean()) < 0.01


def test_hmc_positive_support():
    """test_hmc_vi.py:62-78 (4 chains, 500 + 1500 there): the posterior mean
    of the scale against quadrature of its 1-D posterior."""
    ys = np.array([0.5, -1.2, 0.8, 2.0, -0.3])
    out = hmc(2, normal_scale_model, (),
              Trie.from_dict({"ys": torch.tensor(ys, dtype=torch.float32)}),
              num_samples=150, num_warmup=150, num_chains=32, device="cpu")
    assert out["fused_quadratic"] is False
    scales = out["samples"]["scale"].double().numpy().ravel()
    assert np.all(scales > 0)  # the bijector keeps the support
    grid = np.linspace(1e-3, 10.0, 4000)
    logp = (np.log(grid) * (2.0 - 1.0) - grid  # gamma(2, 1) prior
            + sum(-0.5 * ((y / grid) ** 2) - np.log(grid) for y in ys)
            - 2.5 * np.log(2 * np.pi))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    assert scales.mean() == pytest.approx(float((grid * w).sum()), abs=0.08)


def test_hmc_rejects_discrete_latents():
    @gen
    def m(h):
        b = h.sample(bernoulli, 0.5, "b")
        h.sample(normal, (torch.where(torch.as_tensor(b), 1.0, -1.0), 1.0),
                 "x")

    with pytest.raises(ValueError, match="discrete latent"):
        hmc(3, m, (), Trie.from_dict({"x": 0.3}), num_samples=10,
            num_warmup=10, device="cpu")


def test_hmc_runner_reuse():
    """test_hmc_vi.py:137-150 (8 chains, 200 + 400 there): one runner,
    two keys, different draws, the same posterior."""
    run = hmc_runner(conjugate, (), Trie.from_dict({"x": 1.0}),
                     num_samples=100, num_warmup=100, num_chains=32,
                     **GENERIC)
    m1 = run(0)["samples"]["mu"].double().numpy().ravel()
    m2 = run(1)["samples"]["mu"].double().numpy().ravel()
    assert not np.array_equal(m1, m2)
    assert m1.mean() == pytest.approx(0.5, abs=0.06)
    assert m2.mean() == pytest.approx(0.5, abs=0.06)


# --------------------------------------------------------------------------
# tests/test_pooled_adaptation.py
# --------------------------------------------------------------------------

ys4 = iid(normal, 4)


@gen
def target(h):
    # anisotropic: mu broad, tau narrow, so mass adaptation matters for
    # the step size to land near the target accept rate
    mu = h.sample(normal, (0.0, 3.0), "mu")
    tau = h.sample(normal, (0.0, 0.1), "tau")
    h.sample(ys4, (mu + tau, 1.0), "ys")
    return mu


def _obs():
    return Trie.from_dict({"ys": torch.tensor([0.4, 0.6, 0.5, 0.7])})


def test_pooled_reaches_target_accept_faster():
    """test_pooled_adaptation.py:113-130, as there: a 30-iteration warmup
    from a bad step size; pooled dual averaging sees 64 accept statistics
    an update, per-chain one."""
    kwargs = dict(num_samples=60, num_warmup=30, num_chains=64,
                  step_size=1.5, num_leapfrog=8, target_accept=0.8,
                  **GENERIC)
    pooled = hmc(3, target, (), _obs(), pooled_adaptation=True, **kwargs)
    percha = hmc(3, target, (), _obs(), pooled_adaptation=False, **kwargs)
    assert percha["step_size"].shape == (64,)
    assert percha["inv_mass"].shape == (64, 2)
    a_pool = float(pooled["accept_prob"].mean())
    a_per = float(percha["accept_prob"].mean())
    assert abs(a_pool - 0.8) < abs(a_per - 0.8), (a_pool, a_per)
    assert abs(a_pool - 0.8) < 0.15, a_pool


def test_pooled_posterior_correct():
    """test_pooled_adaptation.py:133-144 (8 chains, 300 + 600 there): the
    conjugate posterior of mu + tau, mean 9/9.01 of its mean for mu."""
    out = hmc(11, target, (), _obs(), num_samples=150, num_warmup=150,
              num_chains=64, pooled_adaptation=True, **GENERIC)
    var_s = 1.0 / (1.0 / 9.01 + 4.0)
    mean_s = var_s * 4.0 * 0.55
    mus = out["samples"]["mu"].double().numpy().ravel()
    assert mus.mean() == pytest.approx(mean_s * 9.0 / 9.01, abs=0.06)
    assert float(out["accept_prob"].mean()) > 0.6


def test_run_warmup_pooled_shapes():
    def transition(k, u, eps, inv_mass):
        z = torch.randn(u.shape, generator=generator(k, "cpu"))
        return u + 0.01 * z, 0.9

    us, eps, inv_mass = run_warmup_pooled(0, torch.zeros((6, 3)), transition,
                                          50, 0.1)
    assert us.shape == (6, 3)
    assert eps.shape == ()
    assert inv_mass.shape == (3,)


def test_adapted_metric_reaches_da_equilibrium_on_stiff_target():
    """test_pooled_adaptation.py:155-185, as there: on a target of
    condition number 1e6 the adapted (eps, metric) land at the
    dual-averaging target with a step size of order 1, not orders below."""
    sds = torch.tensor([0.01, 0.1, 1.0, 10.0])
    xs4 = iid(normal, 4)

    @gen
    def aniso(h):
        h.sample(xs4, (0.0, sds), "x")

    out = hmc(5, aniso, (), Trie(), num_samples=100, num_warmup=300,
              num_chains=32, num_leapfrog=8, **GENERIC)
    acc = float(out["accept_prob"].mean())
    eps = float(out["step_size"])
    assert eps > 0.05, eps
    assert 0.55 < acc < 0.98, acc
    # the stiffest coordinate still moves
    us = out["unconstrained"].double().numpy()
    assert us[:, :, 0].std() > 0.004


def test_fast_pooled_mass_adaptation_far_from_origin_f32():
    """test_pooled_adaptation.py:188-202, as there: mean 1e4, sd 0.1 in
    float32; the centred moment sums keep the adapted metric at the true
    variance."""
    mu0, sd = 10000.0, 0.1

    def logprob(u):
        return -0.5 * torch.sum(((u - mu0) / sd) ** 2)

    u0s = (mu0 + sd * torch.randn((256, 2), generator=generator(0, "cpu"),
                                  dtype=torch.float64)).float()
    out = _pooled_chains(1, logprob, u0s, 200, 50, 0.05, 8, 0.8)
    inv_mass = out[5]
    assert inv_mass.dtype == torch.float32
    ratio = inv_mass.double().numpy() / sd ** 2
    assert np.all(ratio > 0.1) and np.all(ratio < 10.0), ratio
