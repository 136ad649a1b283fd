"""The generic HMC path, port vs reference (CPU, float64).

The transition (``hmc_transition``, ``_transition_batch``), both warmups
(``run_warmup`` per chain, ``run_warmup_pooled``), both chain paths
(``_pooled_chains``, ``_single_chain``) and the models they run on
(``logreg``, ``make_hierarchical_marginalized``) are held to the JAX
package on the same inputs. The port is fed the reference's own random
numbers: the pooled path's ``_phase_randoms`` segments and the per-chain
path's ``split(key, 3)`` draws, made as the reference makes them. Both
sides pass ``use_fused_quadratic=False`` where a runner could detect a
quadratic target (the reference detects only on a TPU).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from modppl_tpu import Trie as JTrie
from modppl_tpu.inference import adaptation as jad
from modppl_tpu.models import hierarchical_static as jhs
from modppl_tpu.models import logreg as jlr
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference import adaptation as tad
from modppl_tpu_torch.interop import (
    chain_phase_draws,
    logreg_data_from_numpy,
    pooled_phase_draws,
    tensor,
)
from modppl_tpu_torch.models import hierarchical_static as ths
from modppl_tpu_torch.models import logreg as tlr
from _torch_threads import one_thread  # noqa: F401

# the package exports the functions hmc and nuts; the modules by path
thmc = importlib.import_module("modppl_tpu_torch.inference.hmc")

# the module: modppl_tpu.inference exports a function of the same name
jhmc = importlib.import_module("modppl_tpu.inference.hmc")

TRANSITION_TOL = dict(rtol=1e-10, atol=1e-10)
CHAIN_TOL = dict(rtol=1e-8, atol=1e-8)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **tol)


def _logreg_data(n=64, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    w = rng.standard_normal(d)
    ys = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ w))).astype(np.float64)
    return X, ys


def _flat_logprobs(j_model, t_model, j_args, t_args):
    """(reference logprob (d,) -> (), port logprob (d,) -> (), dim)."""
    tr, _ = j_model.generate(jax.random.PRNGKey(0), j_args, JTrie())
    lp, u0, _, _ = jhmc.make_unconstrained_logprob(j_model, j_args, tr,
                                                   JTrie())
    _, j_unravel = ravel_pytree(u0)
    ttr, _ = t_model.generate(0, t_args, Trie(), device="cpu")
    tlp, tu0, _, _ = thmc.make_unconstrained_logprob(t_model, t_args, ttr,
                                                     Trie(), device="cpu")
    flat, t_unravel = thmc.ravel_latents(tu0)
    return ((lambda u: lp(j_unravel(u))), (lambda u: tlp(t_unravel(u))),
            flat.shape[0])


def _logreg_logprobs(n=64, d=3):
    X, ys = _logreg_data(n, d)
    return _flat_logprobs(jlr.make_logreg(d), tlr.make_logreg(d),
                          (jnp.asarray(X), jnp.asarray(ys)),
                          logreg_data_from_numpy(X, ys))


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

def test_logreg_logprob_and_gradient_match_reference():
    j_lp, t_lp, d = _logreg_logprobs(128, 16)
    vag = thmc._value_and_grad(t_lp)
    U = np.random.default_rng(1).standard_normal((5, d))
    lp, g = vag(tensor(U))
    j_lp_v, j_g = jax.vmap(jax.value_and_grad(j_lp))(jnp.asarray(U))
    _close(lp, j_lp_v, TRANSITION_TOL)
    _close(g, j_g, TRANSITION_TOL)


def test_hierarchical_marginalized_logprob_matches_reference():
    xs = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
    ys = 0.2 + 0.5 * xs + 0.3 * xs * xs
    j_lp, t_lp, d = _flat_logprobs(
        jhs.make_hierarchical_marginalized(5),
        ths.make_hierarchical_marginalized(5),
        (jnp.asarray(xs), jnp.asarray(ys)), (tensor(xs), tensor(ys)))
    assert d == 3
    for u in np.random.default_rng(2).standard_normal((4, 3)):
        _close(t_lp(tensor(u)), j_lp(jnp.asarray(u)), TRANSITION_TOL)
    tr, _ = ths.make_hierarchical_marginalized(5).generate(
        0, (tensor(xs), tensor(ys)), Trie(), device="cpu")
    a, b, c = (tr.data.read(f"coeffs/{k}") for k in "abc")
    obs = JTrie()
    for k, v in zip("abc", (a, b, c)):
        obs.observe(f"coeffs/{k}", jnp.asarray(float(v)))
    jtr, _ = jhs.make_hierarchical_marginalized(5).generate(
        jax.random.PRNGKey(0), (jnp.asarray(xs), jnp.asarray(ys)), obs)
    _close(tr.retv, jtr.retv, TRANSITION_TOL)


def test_logreg_minibatch_matches_reference():
    X, ys = _logreg_data(40, 4, seed=3)
    idx = np.array([3, 17, 17, 0, 39])
    w = np.random.default_rng(4).standard_normal(4)
    j_model = jlr.make_logreg_minibatch(4, jnp.asarray(X), jnp.asarray(ys))
    t_model = tlr.make_logreg_minibatch(4, *logreg_data_from_numpy(X, ys))
    _, j_w = j_model.generate(jax.random.PRNGKey(0), (jnp.asarray(idx),),
                              JTrie.from_dict({"w": jnp.asarray(w)}))
    _, t_w = t_model.generate(0, (torch.from_numpy(idx),),
                              Trie.from_dict({"w": tensor(w)}),
                              device="cpu")
    _close(t_w, j_w, TRANSITION_TOL)


def test_map_newton_and_simulate_logreg():
    X, ys = _logreg_data(200, 3, seed=5)
    np.testing.assert_allclose(tlr.map_newton(X, ys),
                               np.asarray(jlr.map_newton(X, ys)),
                               rtol=1e-12, atol=1e-12)
    X1, ys1, w1 = tlr.simulate_logreg(42, 128, 16, device="cpu")
    X2, ys2, w2 = tlr.simulate_logreg(42, 128, 16, device="cpu")
    assert X1.shape == (128, 16) and ys1.shape == (128,) and w1.shape == (16,)
    assert X1.dtype == ys1.dtype == torch.float32
    assert torch.equal(X1, X2) and torch.equal(ys1, ys2)
    assert set(ys1.unique().tolist()) == {0.0, 1.0}
    _, _, w = tlr.simulate_logreg(1, 8, 2, w_true=[1.0, -1.0],
                                  device="cpu", dtype=torch.float64)
    assert w.tolist() == [1.0, -1.0] and w.dtype == torch.float64


# --------------------------------------------------------------------------
# the transition
# --------------------------------------------------------------------------

def _reference_transition_draws(key, d):
    """What the reference's hmc_transition draws from ``key``."""
    k_mom, k_acc, k_jit = jax.random.split(key, 3)
    z = jax.random.normal(k_mom, (d,), jnp.float64)
    u01 = jax.random.uniform(k_acc, ())
    jit = jax.random.uniform(k_jit, (), minval=0.5, maxval=1.5)
    return z, jit, u01


@pytest.mark.parametrize("eps", [0.3, 1e3], ids=["step", "divergent"])
def test_hmc_transition_matches_reference(eps):
    j_lp, t_lp, d = _logreg_logprobs()
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    U = np.random.default_rng(8).standard_normal((4, d))
    im = np.linspace(0.5, 2.0, d)
    want = jax.vmap(lambda k, u: jhmc.hmc_transition(
        k, u, j_lp, jax.grad(j_lp), eps, 5, jnp.asarray(im)))(
            keys, jnp.asarray(U))
    z, jit, u01 = jax.vmap(lambda k: _reference_transition_draws(k, d))(keys)
    draws = (tensor(z), tensor(jit), tensor(u01))
    # the batch at once, and chain 0 alone
    got = thmc.hmc_transition(
        None, tensor(U), torch.func.vmap(t_lp),
        torch.func.vmap(torch.func.grad(t_lp)), eps, 5, tensor(im), draws)
    one = thmc.hmc_transition(
        None, tensor(U[0]), t_lp, torch.func.grad(t_lp), eps, 5, tensor(im),
        tuple(x[0] for x in draws))
    for g, o, w in zip(got, one, want):
        _close(g, w, TRANSITION_TOL)
        _close(o, np.asarray(w)[0], TRANSITION_TOL)
    assert bool(got[3].any()) == (eps > 1.0)
    # without draws: the port's own, from the key
    args = (tensor(U), torch.func.vmap(t_lp),
            torch.func.vmap(torch.func.grad(t_lp)), 0.3, 5, tensor(im))
    a, b, c = (thmc.hmc_transition(k, *args) for k in (11, 11, 12))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_transition_batch_matches_reference():
    j_lp, t_lp, d = _logreg_logprobs()
    c = 6
    rng = np.random.default_rng(9)
    U = rng.standard_normal((c, d))
    mom, jit, acc = (rng.standard_normal((c, d)), rng.uniform(0.5, 1.5, c),
                     rng.random(c))
    im = np.linspace(0.3, 1.7, d)
    j_vag = jax.vmap(jax.value_and_grad(j_lp))
    LP, G = j_vag(jnp.asarray(U))
    want = jhmc._transition_batch(j_vag, jnp.asarray(U), LP, G, 0.4,
                                  jnp.asarray(im), jnp.asarray(mom),
                                  jnp.asarray(jit), jnp.asarray(acc), 6)
    vag = thmc._value_and_grad(t_lp)
    tLP, tG = vag(tensor(U))
    _close(tLP, LP, TRANSITION_TOL)
    got = thmc._transition_batch(vag, tensor(U), tLP, tG,
                                 torch.tensor(0.4, dtype=torch.float64),
                                 tensor(im), tensor(mom), tensor(jit),
                                 tensor(acc), 6)
    for g, w in zip(got, want):
        _close(g, w, TRANSITION_TOL)


# --------------------------------------------------------------------------
# the warmups, driven by one deterministic transition on both sides
# --------------------------------------------------------------------------

def _j_step(k, u, eps, inv_mass):
    u = 0.9 * u + 0.1 + 0.05 * eps * inv_mass
    return u, jax.nn.sigmoid(jnp.sum(u) - 1.5)


def _t_step_batched(x, us, eps, inv_mass):
    eps = eps[:, None] if eps.ndim == 1 else eps
    us = 0.9 * us + 0.1 + 0.05 * eps * inv_mass
    return us, torch.sigmoid(torch.sum(us, -1) - 1.5)


def _t_step(k, u, eps, inv_mass):
    u = 0.9 * u + 0.1 + 0.05 * eps * inv_mass
    return u, torch.sigmoid(torch.sum(u) - 1.5)


def _u0s(c=8, d=3):
    return np.random.default_rng(10).standard_normal((c, d)) * 2.0


@pytest.mark.parametrize("num_warmup", [15, 150])
def test_run_warmup_per_chain_matches_reference(num_warmup):
    """The batch as one against the reference vmapped over chains."""
    u0s = _u0s()
    key = jax.random.PRNGKey(0)
    want = jax.vmap(lambda u: jad.run_warmup(key, u, _j_step, num_warmup,
                                             0.1))(jnp.asarray(u0s))
    got = tad.run_warmup(0, tensor(u0s), _t_step_batched, num_warmup, 0.1)
    assert got[1].shape == (8,) and got[2].shape == (8, 3)
    for g, w in zip(got, want):
        _close(g, w, TRANSITION_TOL)


@pytest.mark.parametrize("batched", [True, False])
def test_run_warmup_pooled_matches_reference(batched):
    u0s = _u0s()
    want = jad.run_warmup_pooled(jax.random.PRNGKey(0), jnp.asarray(u0s),
                                 _j_step, 150, 0.1)
    got = tad.run_warmup_pooled(0, tensor(u0s),
                                _t_step_batched if batched else _t_step,
                                150, 0.1, batched_transition=batched)
    assert got[1].shape == () and got[2].shape == (3,)
    for g, w in zip(got, want):
        _close(g, w, TRANSITION_TOL)


def test_pooled_sum_is_the_reference_tree_and_one_device_only():
    """The one-device sum is the reference's tree. Over a mesh axis the
    sum needs the mesh (``with mesh:``), and over a mesh of this one
    process it is the same tree; the multi-shard sums are
    tests/test_torch_sharded_mcmc.py's."""
    from modppl_tpu_torch.parallel.mesh import make_mesh

    x = np.random.default_rng(11).standard_normal((37, 5))
    want = np.asarray(jad._pooled_sum(jnp.asarray(x), None))
    np.testing.assert_array_equal(tad._pooled_sum(tensor(x)).numpy(), want)
    with pytest.raises(RuntimeError, match="outside a mesh"):
        tad._pooled_sum(tensor(x), "dp")
    with pytest.raises(RuntimeError, match="outside a mesh"):
        tad.run_warmup_pooled(0, tensor(x), _t_step_batched, 10, 0.1,
                              axis_name="dp", batched_transition=True)
    with make_mesh():
        np.testing.assert_array_equal(
            tad._pooled_sum(tensor(x), "dp").numpy(), want)


# --------------------------------------------------------------------------
# both chain paths, on the reference's draws
# --------------------------------------------------------------------------

NUM_WARMUP, NUM_SAMPLES, LEAPFROG = 60, 20, 4


def _phase_keys(key, num_warmup):
    """The reference's phase keys: warmup phase i fold_in(fold_in(key, 0),
    i), then sampling fold_in(key, 2); and each phase's length."""
    fast1, slow, fast2 = jad.warmup_schedule(num_warmup)
    lengths = [n for n in [fast1, *slow, fast2] if n > 0]
    k_warm = jax.random.fold_in(key, 0)
    keys = [jax.random.fold_in(k_warm, i) for i in range(len(lengths))]
    return keys + [jax.random.fold_in(key, 2)], lengths + [NUM_SAMPLES]


def _accepts(aprobs, u01s):
    """Sampling accept decisions (chains, samples) from the uniforms
    (samples, chains)."""
    return np.asarray(u01s).T < np.asarray(aprobs)


def _hold_chains(got, want, u01s):
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        _close(g, w, CHAIN_TOL)
    np.testing.assert_array_equal(_accepts(got[2], u01s),
                                  _accepts(want[2], u01s))


def test_pooled_chains_match_reference():
    """16 chains, 60 + 20 iterations (one slow window), fed the reference's
    _phase_randoms segments."""
    j_lp, t_lp, d = _logreg_logprobs()
    c = 16
    u0s = np.random.default_rng(12).standard_normal((c, d)) * 0.5
    key = jax.random.PRNGKey(13)
    gidx = jnp.arange(c)
    draws = []
    for pk, length in zip(*_phase_keys(key, NUM_WARMUP)):
        segs, done, seg = [], 0, 0
        while done < length:
            w = min(jhmc._PREDRAW_SEG, length - done)
            segs.append(jhmc._phase_randoms(jax.random.fold_in(pk, seg),
                                            gidx, w, d, jnp.float64))
            done, seg = done + w, seg + 1
        draws.append(pooled_phase_draws(segs))
    assert len(draws) == 4
    want = jhmc._pooled_chains(key, j_lp, jnp.asarray(u0s), NUM_WARMUP,
                               NUM_SAMPLES, 0.1, LEAPFROG, 0.8)
    got = thmc._pooled_chains(0, t_lp, tensor(u0s), NUM_WARMUP, NUM_SAMPLES,
                              0.1, LEAPFROG, 0.8, draws=draws)
    assert got[4].shape == () and got[5].shape == (d,)
    _hold_chains(got, want, draws[-1][2])


def test_single_chain_matches_reference():
    """4 chains against jax.vmap(_single_chain), fed each chain's
    split(key, 3) draws."""
    j_lp, t_lp, d = _logreg_logprobs()
    c = 4
    u0s = np.random.default_rng(14).standard_normal((c, d)) * 0.5
    chain_keys = jax.random.split(jax.random.PRNGKey(15), c)

    def chain_draws(k):
        out = []
        for pk, length in zip(*_phase_keys(k, NUM_WARMUP)):
            z, jit, u01 = jax.vmap(
                lambda kk: _reference_transition_draws(kk, d))(
                    jax.random.split(pk, length))
            out.append((z, u01, jit))
        return out

    per_chain = jax.vmap(chain_draws)(chain_keys)
    draws = [chain_phase_draws(*phase) for phase in per_chain]
    want = jax.vmap(lambda k, u: jhmc._single_chain(
        k, j_lp, u, NUM_WARMUP, NUM_SAMPLES, 0.1, LEAPFROG, 0.8))(
            chain_keys, jnp.asarray(u0s))
    got = thmc._single_chain(0, t_lp, tensor(u0s), NUM_WARMUP, NUM_SAMPLES,
                             0.1, LEAPFROG, 0.8, draws=draws)
    assert got[4].shape == (c,) and got[5].shape == (c, d)
    _hold_chains(got, want, draws[-1][2])


def test_draws_are_checked():
    _, t_lp, d = _logreg_logprobs()
    u0s = tensor(np.zeros((4, d)))
    z = torch.zeros((5, 4, d), dtype=torch.float64)
    one = (z, torch.ones((5, 4), dtype=torch.float64), torch.zeros((5, 4)))
    with pytest.raises(ValueError, match="one entry per phase"):
        thmc._pooled_chains(0, t_lp, u0s, 5, 5, 0.1, 2, 0.8, draws=[one])
    with pytest.raises(ValueError, match="needs z of shape"):
        thmc._single_chain(0, t_lp, u0s, 4, 5, 0.1, 2, 0.8,
                           draws=[one, one])


# --------------------------------------------------------------------------
# hmc_runner on the generic path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pooled", [True, False])
def test_runner_generic_path_shapes_and_determinism(pooled):
    X, ys = _logreg_data(64, 3)
    run = thmc.hmc_runner(tlr.make_logreg(3), logreg_data_from_numpy(X, ys),
                          Trie(), num_samples=6, num_warmup=25,
                          num_chains=5, num_leapfrog=3,
                          pooled_adaptation=pooled, device="cpu")
    out, again = run(3), run(3)
    assert run.quadratic is None
    assert out["fused_quadratic"] is False and bool(out["quad_check_ok"])
    assert out["samples"]["w"].shape == (5, 6, 3)
    assert out["unconstrained"].shape == (5, 6, 3)
    assert out["logp"].shape == out["accept_prob"].shape == (5, 6)
    assert out["divergences"].dtype == torch.bool
    assert out["inv_mass"].shape == ((3,) if pooled else (5, 3))
    assert out["step_size"].shape == (() if pooled else (5,))
    for k in ("unconstrained", "logp", "accept_prob", "step_size",
              "inv_mass"):
        assert torch.equal(out[k], again[k]), k
    assert not torch.equal(out["unconstrained"], run(4)["unconstrained"])


def test_runner_refuses_axis_name():
    """With ``axis_name`` the runner refuses the fused quadratic path, as
    the reference does, and runs only inside a mesh: over a mesh of this
    one process it is the one-device run of its chains."""
    from modppl_tpu_torch.parallel.mesh import make_mesh

    X, ys = _logreg_data(16, 2)
    args = (tlr.make_logreg(2), logreg_data_from_numpy(X, ys), Trie())
    kw = dict(num_chains=4, num_warmup=10, num_samples=5, num_leapfrog=3,
              device="cpu")
    with pytest.raises(ValueError, match="use_fused_quadratic=True"):
        thmc.hmc_runner(*args, axis_name="dp", use_fused_quadratic=True,
                        **kw)
    run = thmc.hmc_runner(*args, axis_name="dp", **kw)
    with pytest.raises(RuntimeError, match="outside a mesh"):
        run(0)
    with make_mesh():
        out = run(0)
    assert out["unconstrained"].shape == (4, 5, 2)
    assert not out["fused_quadratic"]


def test_runner_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    X, ys = _logreg_data(16, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thmc.hmc_runner(tlr.make_logreg(2), logreg_data_from_numpy(X, ys),
                        Trie(), num_chains=4)


@pytest.mark.parametrize("chains", ["per_chain", "pooled"])
def test_chain_paths_run_the_batch_as_one(chains):
    """The log-density runs once per batched call, whatever the number of
    chains: neither path loops over chains."""
    _, t_lp, d = _logreg_logprobs()
    calls = []

    def counted(u):
        calls.append(1)
        return t_lp(u)

    fn = thmc._single_chain if chains == "per_chain" else thmc._pooled_chains
    counts = []
    for c in (2, 9):
        calls.clear()
        u0s = tensor(np.random.default_rng(c).standard_normal((c, d)))
        fn(0, counted, u0s, 25, 5, 0.1, 3, 0.8)
        counts.append(len(calls))
    assert counts[0] == counts[1] > 0
