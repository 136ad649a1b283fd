"""Fixed-step quadratic HMC, port vs reference (CPU): the single-transition
kernel's plain version (d <= 7), the fused leapfrog's (any d), and the
``hmc_transition_quadratic`` / ``hmc_quadratic`` entries built on them.

The reference's Pallas kernels run in interpret mode, as its own tests run
them. The port is fed the reference's own random numbers, drawn as its
entries draw them (``jax.random.split``), so in float64 both sides agree to
1e-9 and make the same accept decisions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.ops import leapfrog_pallas as jmxu
from modppl_tpu.ops import leapfrog_vpu_pallas as jvpu
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.ops import leapfrog, leapfrog_small
from _torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-9, atol=1e-9)


def _target(d, seed=0):
    """tests/test_leapfrog_pallas.py:21-26: a well-conditioned precision
    and its mean, float64."""
    a = jax.random.normal(jax.random.PRNGKey(seed), (d, d))
    lam = a @ a.T + d * jnp.eye(d)
    mean = jnp.arange(1.0, d + 1.0) / d
    return np.asarray(lam), np.asarray(lam @ mean), np.asarray(mean)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("d,n,steps", [(5, 12, 7), (20, 9, 5)])
def test_fused_leapfrog_plain_matches_reference(d, n, steps):
    """tests/test_leapfrog_pallas.py:29-48's trajectory, against the
    interpret-mode Pallas kernel, at 1e-10."""
    lam, b, _ = _target(d)
    im = np.linspace(0.5, 1.5, d)
    rng = np.random.default_rng(d)
    u0, p0 = rng.standard_normal((n, d)), rng.standard_normal((n, d))
    eps = np.linspace(0.01, 0.03, n)
    j_u, j_p = jmxu.fused_leapfrog(jnp.asarray(u0), jnp.asarray(p0),
                                   jnp.asarray(eps), jnp.asarray(lam),
                                   jnp.asarray(b), jnp.asarray(im), steps,
                                   interpret=True)
    args = (tensor(u0), tensor(p0), tensor(eps), tensor(lam), tensor(b),
            tensor(im), steps)
    tol = dict(rtol=1e-10, atol=1e-10)
    u, p = leapfrog.fused_leapfrog_plain(*args)
    _close(u, j_u, tol)
    _close(p, j_p, tol)
    u, p = leapfrog.fused_leapfrog(*args)   # the wrapper, on the CPU
    _close(u, j_u, tol)
    _close(p, j_p, tol)
    assert leapfrog.fused_leapfrog.launches == 0
    # a scalar step size broadcasts to every chain
    u, _ = leapfrog.fused_leapfrog(*args[:2], 0.02, *args[3:])
    _close(u, leapfrog.fused_leapfrog_plain(
        *args[:2], torch.full((n,), 0.02, dtype=torch.float64), *args[3:])[0])


def test_fused_leapfrog_does_not_clamp():
    """The reference's gradient is b - uΛ with no clamp: a position beyond
    1e30 moves by its own gradient (the chunk kernels' clamp would stop
    it)."""
    d = 3
    lam, b = np.eye(d), np.zeros(d)
    u0 = np.full((1, d), 1e35)
    u, _ = leapfrog.fused_leapfrog_plain(
        tensor(u0), tensor(np.zeros((1, d))), tensor(np.array([0.1])),
        tensor(lam), tensor(b), tensor(np.ones(d)), 1)
    assert float(u[0, 0]) == pytest.approx(1e35 * (1 - 0.005), rel=1e-12)


@pytest.mark.parametrize("d", [3, 7])
def test_transition_small_plain_matches_reference(d):
    """All six outputs of hmc_transition_small, at 1e-10, on the same p,
    eps and u01 (some chains reject)."""
    lam, b, _ = _target(d, seed=d)
    n, steps = 300, 4
    rng = np.random.default_rng(100 + d)
    u0 = rng.standard_normal((n, d)) * 0.5
    im = 0.5 + rng.random(d)
    p0 = rng.standard_normal((n, d)) / np.sqrt(im)
    eps = (0.6 if d == 3 else 0.35) * (0.5 + rng.random(n))
    u01 = rng.random(n)
    want = jvpu.hmc_transition_small(
        jnp.asarray(u0), jnp.asarray(p0), jnp.asarray(eps), jnp.asarray(u01),
        jnp.asarray(lam), jnp.asarray(b), jnp.asarray(im), steps,
        interpret=True)
    args = (tensor(u0), tensor(p0), tensor(eps), tensor(u01), tensor(lam),
            tensor(b), tensor(im), steps)
    tol = dict(rtol=1e-10, atol=1e-10)
    for got in (leapfrog_small.transition_small_plain(*args),
                leapfrog_small.hmc_transition_small(*args)):
        (u, p), lp, ap, dv, h0, h1 = got
        (j_u, j_p), j_lp, j_ap, j_dv, j_h0, j_h1 = want
        for x, y in ((u, j_u), (p, j_p), (lp, j_lp), (ap, j_ap), (h0, j_h0),
                     (h1, j_h1)):
            _close(x, y, tol)
        np.testing.assert_array_equal(dv.numpy(), np.asarray(j_dv))
        accepted = (u01 < ap.numpy())
        assert 0.2 < accepted.mean() < 1.0
    assert leapfrog_small.hmc_transition_small.launches == 0
    j_uL, j_pL, j_h0, j_h1 = jvpu.fused_leapfrog_small(
        jnp.asarray(u0), jnp.asarray(p0), jnp.asarray(eps), jnp.asarray(lam),
        jnp.asarray(b), jnp.asarray(im), steps, interpret=True)
    uL, pL, h0, h1 = leapfrog_small.fused_leapfrog_small(
        tensor(u0), tensor(p0), tensor(eps), tensor(lam), tensor(b),
        tensor(im), steps)
    for x, y in ((uL, j_uL), (pL, j_pL), (h0, j_h0), (h1, j_h1)):
        _close(x, y, tol)


def _transition_draws(key, n, d):
    """hmc_transition_quadratic's streams: split(key) -> momenta, accept
    uniforms."""
    k_mom, k_acc = jax.random.split(key)
    return (tensor(np.asarray(jax.random.normal(k_mom, (n, d)))),
            tensor(np.asarray(jax.random.uniform(k_acc, (n,)))))


def _chain_draws(key, num, n, d):
    """hmc_quadratic's streams as (z, jit, u01), each transition's from
    split(key, num)[t] -> (k_jit, k_tr), k_tr -> (k_mom, k_acc)."""
    zs, jits, u01s = [], [], []
    for k in jax.random.split(key, num):
        k_jit, k_tr = jax.random.split(k)
        jits.append(np.asarray(jax.random.uniform(
            k_jit, (n,), minval=0.5, maxval=1.5)))
        z, u01 = _transition_draws(k_tr, n, d)
        zs.append(z)
        u01s.append(u01)
    return torch.stack(zs), tensor(np.stack(jits)), torch.stack(u01s)


@pytest.mark.parametrize("d", [3, 20])
def test_hmc_transition_quadratic_matches_reference(d):
    """One transition on the reference's draws: d = 3 through the
    single-transition kernel, d = 20 through fused_leapfrog and the plain
    energies and accept."""
    lam, b, mean = _target(d, seed=2)
    n = 64
    rng = np.random.default_rng(d)
    u = mean + rng.standard_normal((n, d)) * 0.3
    im = 0.7 + rng.random(d) * 0.6
    eps = np.full(n, 0.25 if d == 3 else 0.1)
    key = jax.random.PRNGKey(4 + d)
    want = jmxu.hmc_transition_quadratic(
        key, jnp.asarray(u), jnp.asarray(eps), jnp.asarray(lam),
        jnp.asarray(b), jnp.asarray(im), 8, interpret=True)
    got = leapfrog.hmc_transition_quadratic(
        None, tensor(u), tensor(eps), tensor(lam), tensor(b), tensor(im), 8,
        draws=_transition_draws(key, n, d))
    for x, y in zip(got[:3], want[:3]):
        _close(x, y)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    moved = np.any(got[0].numpy() != u, axis=1)
    assert 0.0 < moved.mean()


@pytest.mark.parametrize("d", [3, 20])
def test_hmc_quadratic_matches_reference(d):
    """The whole fixed-step run, transition by transition on the
    reference's draws, at 1e-9."""
    lam, b, mean = _target(d, seed=3)
    n, T = 16, 12
    u0 = mean + np.random.default_rng(7).standard_normal((n, d)) * 0.5
    im = np.ones(d)
    key = jax.random.PRNGKey(11)
    step = 0.3 if d == 3 else 0.12
    want = jmxu.hmc_quadratic(key, jnp.asarray(u0), jnp.asarray(lam),
                              jnp.asarray(b), jnp.asarray(im),
                              step_size=step, num_samples=T, num_leapfrog=6,
                              interpret=True)
    got = leapfrog.hmc_quadratic(None, tensor(u0), tensor(lam), tensor(b),
                                 tensor(im), step_size=step, num_samples=T,
                                 num_leapfrog=6,
                                 draws=_chain_draws(key, T, n, d))
    for k in ("samples", "logp", "accept_prob"):
        _close(got[k], want[k])
    np.testing.assert_array_equal(got["divergences"].numpy(),
                                  np.asarray(want["divergences"]))
    assert got["samples"].shape == (T, n, d)


def test_hmc_quadratic_recovers_moments():
    """tests/test_leapfrog_pallas.py:69-82 on the port's own streams."""
    d = 2
    lam, b, mean = _target(d, seed=5)
    cov = np.linalg.inv(lam)
    u0 = tensor(np.random.default_rng(6).standard_normal((64, d)))
    out = leapfrog.hmc_quadratic(7, u0, tensor(lam), tensor(b),
                                 torch.ones(d, dtype=torch.float64),
                                 step_size=0.3, num_samples=300,
                                 num_leapfrog=8)
    flat = out["samples"][100:].numpy().reshape(-1, d)
    np.testing.assert_allclose(flat.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.08)
    assert not bool(out["divergences"].any())


def test_tf32_guard(monkeypatch):
    """At d >= 8 the accept ratio comes from a matmul: on the card the
    transition raises while TF32 is allowed; on the CPU (no TF32) it runs."""
    assert not leapfrog._tf32_on()
    leapfrog.require_full_fp32(torch.device("cuda"))
    monkeypatch.setattr(leapfrog, "_tf32_on", lambda: True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        leapfrog.require_full_fp32(torch.device("cuda"))
    leapfrog.require_full_fp32(torch.device("cpu"))
    d, n = 9, 4
    lam, b, mean = _target(d)
    out = leapfrog.hmc_transition_quadratic(
        3, tensor(np.tile(mean, (n, 1))), 0.1, tensor(lam), tensor(b),
        torch.ones(d, dtype=torch.float64), 4)
    assert bool(torch.isfinite(out[1]).all())
