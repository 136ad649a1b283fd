"""MALA, port vs reference (CPU, float64).

The reference's ``mala_transition`` and its vmapped ``_single_chain`` are
held to the port's batched transition and ``_chains`` on the reference's
own draws (each chain's split keys' normals and uniforms, made as the
reference makes them): one transition at 1e-12, a short warmup and
sampling run at 1e-9. The reference's gates (``tests/test_mala.py``) run
on the port at its configurations.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import gamma, iid, normal
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

# the package exports the functions hmc and nuts; the modules by path
thmc = importlib.import_module("modppl_tpu_torch.inference.hmc")

jmala = importlib.import_module("modppl_tpu.inference.mala")
# the module (the package exports a function of the same name)
tmala = importlib.import_module("modppl_tpu_torch.inference.mala")

STEP_TOL = dict(rtol=1e-12, atol=1e-12)
RUN_TOL = dict(rtol=1e-9, atol=1e-9)
LAM = np.diag([1.0, 2.0, 0.5]) + 0.3     # a correlated quadratic target


def _jlogp(u):
    return -0.5 * u @ jnp.asarray(LAM) @ u + jnp.sin(u[0])


def _tlogp(u):
    return -0.5 * u @ tensor(LAM) @ u + torch.sin(u[0])


def _ref_draws(keys, d):
    """(noise (T, C, d), u01 (T, C)) from per-chain step keys (C, T)."""
    noise, u01 = [], []
    for chain in keys:
        n_c, u_c = [], []
        for k in chain:
            k_noise, k_acc = jax.random.split(k)
            n_c.append(np.asarray(jax.random.normal(k_noise, (d,),
                                                    jnp.float64)))
            u_c.append(float(jax.random.uniform(k_acc, (), jnp.float64)))
        noise.append(n_c)
        u01.append(u_c)
    return (tensor(np.swapaxes(np.array(noise), 0, 1)),
            tensor(np.array(u01).T))


def test_transition_matches_reference():
    rng = np.random.default_rng(0)
    C, d = 6, 3
    U = rng.standard_normal((C, d))
    eps = np.array([0.1, 0.3, 0.5, 0.8, 1.2, 2.0])
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    vg = jax.vmap(jax.value_and_grad(_jlogp))
    lp, g = vg(jnp.asarray(U))
    want = jax.vmap(lambda k, u, l, gg, e: jmala.mala_transition(
        k, u, l, gg, _jlogp, jax.grad(_jlogp), e))(
        keys, jnp.asarray(U), lp, g, jnp.asarray(eps))
    noise, u01 = _ref_draws(np.asarray(keys)[:, None], d)
    vag = thmc._value_and_grad(_tlogp)
    got = tmala.mala_transition(
        None, tensor(U), tensor(np.asarray(lp)), tensor(np.asarray(g)),
        lambda x: vag(x)[0], lambda x: vag(x)[1], tensor(eps),
        draws=(noise[0], u01[0]))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STEP_TOL)
    # some chains accept and some reject, so both arms are held
    moved = (got[0] != tensor(U)).any(-1)
    assert 0 < int(moved.sum()) < C


def test_chains_match_reference_single_chain():
    C, d, W, S = 4, 3, 30, 20
    u0s = np.random.default_rng(1).standard_normal((C, d))
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    us, logps, aprobs, eps = jax.vmap(
        lambda k, u: jmala._single_chain(k, _jlogp, u, W, S, 0.2, 0.574))(
        keys, jnp.asarray(u0s))
    warm_keys = [jax.random.split(jax.random.fold_in(k, 0), W) for k in keys]
    samp_keys = [jax.random.split(jax.random.fold_in(k, 1), S) for k in keys]
    got = tmala._chains(0, _tlogp, tensor(u0s), W, S, 0.2, 0.574,
                        draws=(_ref_draws(warm_keys, d),
                               _ref_draws(samp_keys, d)))
    for a, b in zip(got, (us, logps, aprobs, eps)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **RUN_TOL)


# --------------------------------------------------------------------------
# the reference's gates (tests/test_mala.py), on the port
# --------------------------------------------------------------------------

@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")
    return mu


ys5 = iid(normal, 5)


@gen
def scale_model(h):
    scale = h.sample(gamma, (2.0, 1.0), "scale")
    h.sample(ys5, (0.0, scale), "ys")


def test_mala_conjugate_posterior():
    out = tmala.mala(0, conjugate, (), Trie.from_dict({"x": 1.0}),
                     num_samples=4000, num_warmup=1000, num_chains=4,
                     device="cpu")
    mus = out["samples"]["mu"].double().numpy().ravel()
    assert mus.mean() == pytest.approx(0.5, abs=0.05)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.05)
    # dual averaging lands near the Langevin optimal-scaling target
    assert 0.35 < float(torch.mean(out["accept_prob"])) < 0.8


def test_mala_positive_support_bijector():
    data = torch.tensor([0.3, -0.5, 0.8, 0.1, -0.2])
    out = tmala.mala(1, scale_model, (), Trie.from_dict({"ys": data}),
                     num_samples=3000, num_warmup=1000, num_chains=4,
                     device="cpu")
    scales = out["samples"]["scale"].double().numpy().ravel()
    assert bool(np.all(scales > 0.0))
    # quadrature oracle for E[scale | ys]
    grid = np.linspace(1e-3, 6.0, 4001)
    d = data.double().numpy()
    lps = (np.log(grid) - grid
           + np.sum(-0.5 * (d[None, :] / grid[:, None]) ** 2
                    - np.log(grid[:, None]), axis=1))
    w = np.exp(lps - lps.max())
    exact_mean = float(np.sum(grid * w) / np.sum(w))
    assert scales.mean() == pytest.approx(exact_mean, abs=0.08)


def test_mala_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obs = Trie.from_dict({"x": 1.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmala.mala(0, conjugate, (), obs, num_samples=2, num_warmup=2)
    out = tmala.mala(0, conjugate, (), obs, num_samples=3, num_warmup=2,
                     num_chains=2, device="cpu")
    assert out["unconstrained"].shape == (2, 3, 1)
    assert out["step_size"].shape == (2,)
