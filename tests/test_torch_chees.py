"""ChEES-HMC, port vs reference (CPU, float64).

``halton`` is held bitwise, the τ Adam at 1e-12, ``_chees_transition`` at
1e-10 (dynamic and masked static steps), and whole ``run.chains``
pipelines at 1e-9 on injected start points and the reference's own draws
(its ``_phase_randoms`` segments, carried by
``interop.chees_phase_draws``): one warmup iteration and one sample, then
a 21-iteration warmup (10 fast, ONE slow iteration with its Welford merge
and the window's metric, 10 fast) and one sample, which between them hold
the dual averaging, the τ floor and clip, the accept-weighted ChEES
gradient with its divergence mask and the Adam step. Longer runs part at
a growing rate (max differences 2e-11 after 23 iterations, 1e-6 after 25,
0.6 after 40 on this target): the adaptation feeds each iteration's
rounding into the next step size and τ, so the pipeline is held where the
two still agree to 1e-9 and the gates below check the long runs. The reference's
gates (``tests/test_chees.py``) run on the port at its configurations;
``test_shardmap_chees_matches_single_device`` waits for multi-device
(ROADMAP Queue 1 item 14). The reference ignores ``max_leapfrog`` when
``static_unroll`` is set (``modppl_tpu/inference/chees.py:225``); the port
caps at both, and ``test_reference_static_unroll_ignores_max_leapfrog``
marks the difference.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu.models import hierarchical_static as jhs
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import iid, normal
from modppl_tpu_torch.inference.adaptation import warmup_phases
from modppl_tpu_torch.interop import chees_phase_draws, tensor
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models import hierarchical_static as ths
from _torch_threads import one_thread  # noqa: F401

# the package exports the functions hmc and nuts; the modules by path
thmc = importlib.import_module("modppl_tpu_torch.inference.hmc")

jchees = importlib.import_module("modppl_tpu.inference.chees")
# the module (the package exports a function of the same name)
tchees = importlib.import_module("modppl_tpu_torch.inference.chees")

STEP_TOL = dict(rtol=1e-10, atol=1e-10)
RUN_TOL = dict(rtol=1e-9, atol=1e-9)
LAM = np.diag([1.0, 2.0, 0.5])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **tol)


def test_halton_matches_reference_bitwise():
    for base in (2, 3):
        h = tchees.halton(257, base)
        assert np.array_equal(h, jchees.halton(257, base))
    h = tchees.halton(64)
    assert h.shape == (64,) and (h > 0).all() and (h < 1).all()
    np.testing.assert_allclose(h[:4], [0.5, 0.25, 0.75, 0.125])


def test_adam_matches_reference():
    st_j = jchees._adam_init(jnp.log(0.7))
    st_t = tchees._adam_init(torch.log(torch.tensor(0.7, dtype=torch.float64)))
    for g in np.random.default_rng(0).standard_normal(25):
        st_j = jchees._adam_update(st_j, jnp.asarray(g), 0.025)
        st_t = tchees._adam_update(st_t, tensor(g), 0.025)
        for k in st_j:
            _close(st_t[k], st_j[k], dict(rtol=1e-12, atol=1e-12))


def _quadratic():
    rng = np.random.default_rng(0)
    n, d = 16, 3
    jvag = jax.vmap(jax.value_and_grad(
        lambda u: -0.5 * u @ jnp.asarray(LAM) @ u))
    tvag = thmc._value_and_grad(lambda u: -0.5 * u @ tensor(LAM) @ u)
    U = rng.standard_normal((n, d))
    im = np.asarray([1.0, 0.7, 1.3])
    mom = rng.standard_normal((n, d))
    acc = rng.random(n)
    return jvag, tvag, U, im, mom, acc


def test_transition_matches_reference_and_static_matches_dynamic():
    """Every step count below the cap: the port's dynamic and static
    transitions both equal the reference's dynamic one (the
    static/dynamic equivalence gate of tests/test_chees.py)."""
    jvag, tvag, U, im, mom, acc = _quadratic()
    jLP, jG = jvag(jnp.asarray(U))
    tLP, tG = tvag(tensor(U))
    for ns in [1, 5, 12, 16]:
        want = jchees._chees_transition(
            jvag, jnp.asarray(U), jLP, jG, 0.2, jnp.asarray(ns),
            jnp.asarray(im), jnp.asarray(mom), jnp.asarray(acc), 1000)
        for su in (None, 16):
            got = tchees._chees_transition(
                tvag, tensor(U), tLP, tG, 0.2, torch.tensor(ns), tensor(im),
                tensor(mom), tensor(acc), 1000, static_unroll=su)
            for a, b in zip(got, want):
                _close(a, b, STEP_TOL)


def test_reference_static_unroll_ignores_max_leapfrog():
    """Asked for 10 steps with max_leapfrog = 4 and static_unroll = 16, the
    reference's static arm runs 10 steps (chees.py:225 clips at the unroll
    only); the port's runs 4, as both packages' dynamic arms do."""
    jvag, tvag, U, im, mom, acc = _quadratic()
    jLP, jG = jvag(jnp.asarray(U))
    tLP, tG = tvag(tensor(U))
    args_j = (jvag, jnp.asarray(U), jLP, jG, 0.2, jnp.asarray(10),
              jnp.asarray(im), jnp.asarray(mom), jnp.asarray(acc), 4)
    args_t = (tvag, tensor(U), tLP, tG, 0.2, torch.tensor(10), tensor(im),
              tensor(mom), tensor(acc), 4)
    ref_dynamic = jchees._chees_transition(*args_j)
    ref_static = jchees._chees_transition(*args_j, static_unroll=16)
    port_static = tchees._chees_transition(*args_t, static_unroll=16)
    port_dynamic = tchees._chees_transition(*args_t)
    for a, b, c in zip(port_static, port_dynamic, ref_dynamic):
        _close(a, b.numpy(), STEP_TOL)
        _close(a, c, STEP_TOL)
    # the reference's static arm moved further: its proposal differs
    assert not np.allclose(np.asarray(ref_static[5]),
                           np.asarray(ref_dynamic[5]))


def _hier_data():
    xs = np.linspace(-1.0, 1.0, 6)
    ys = 0.3 + 0.5 * xs - 0.8 * xs * xs + 0.1 * np.random.default_rng(
        0).standard_normal(6)
    return xs, ys


def _runners(**kw):
    """Both packages' runners on the hierarchical model with the gate
    observed (a float64 d = 3 target)."""
    xs, ys = _hier_data()
    jrun = jchees.chees_runner(
        jhs.make_hierarchical_static(6), (jnp.asarray(xs),),
        JTrie.from_dict({"ys": jnp.asarray(ys), "is_linear": False}), **kw)
    trun = tchees.chees_runner(
        ths.make_hierarchical_static(6), (tensor(xs),),
        Trie.from_dict({"ys": tensor(ys), "is_linear": False}),
        device="cpu", **kw)
    return jrun, trun


def _ref_draws(k_run, num_warmup, num_samples, num_chains, dim):
    """The reference's segments, as its run.chains draws them."""
    gidx = jnp.arange(num_chains)

    def phase(phase_key, length):
        segs, done, seg = [], 0, 0
        while done < length:
            k = min(jchees._PREDRAW_SEG, length - done)
            segs.append(jchees._phase_randoms(
                jax.random.fold_in(phase_key, seg), gidx, k, dim,
                jnp.float64))
            done += k
            seg += 1
        return chees_phase_draws(segs)

    k_warm = jax.random.fold_in(k_run, 0)
    draws = [phase(jax.random.fold_in(k_warm, i), length)
             for i, (length, _) in enumerate(warmup_phases(num_warmup))]
    return draws + [phase(jax.random.fold_in(k_run, 2), num_samples)]


@pytest.mark.parametrize("static_unroll,num_warmup,num_samples",
                         [(None, 1, 1), (8, 1, 1), (None, 21, 1)])
def test_chains_match_reference_on_its_draws(static_unroll, num_warmup,
                                             num_samples):
    chains = 8
    kw = dict(num_samples=num_samples, num_warmup=num_warmup,
              num_chains=chains, step_size=0.05, static_unroll=static_unroll)
    jrun, trun = _runners(**kw)
    u0s = np.random.default_rng(5).standard_normal((chains, 3)) * 0.3
    k_run = jax.random.PRNGKey(11)
    want = jrun.chains(k_run, jnp.asarray(u0s))
    got = trun.chains(0, tensor(u0s), draws=_ref_draws(
        k_run, num_warmup, num_samples, chains, 3))
    for a, b in zip(got, want):
        _close(a, b, RUN_TOL)
    assert int(got[4].min()) >= 1


# --------------------------------------------------------------------------
# the reference's gates (tests/test_chees.py), on the port
# --------------------------------------------------------------------------

@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 0.5), "x")
    return mu


@pytest.mark.parametrize("static_unroll", [None, 16])
def test_chees_conjugate_posterior(static_unroll):
    """Posterior N(0.8, 0.2); one shared step count an iteration; with
    static_unroll the counts stay at or below the unroll.

    Shortened for time, bounds unchanged: 200 + 300 iterations, the first
    100 samples dropped (the reference: 300 + 400, the first 100 dropped;
    ~15 s a gate on a CPU at full length). ``chip_smoke.py`` phase 22
    runs both at the reference's configuration on the card."""
    out = tchees.chees(0, conjugate, (), Trie.from_dict({"x": 1.0}),
                       num_samples=300, num_warmup=200, num_chains=32,
                       static_unroll=static_unroll, device="cpu")
    mus = out["samples"]["mu"][:, 100:].double().numpy().ravel()
    assert abs(mus.mean() - 0.8) < 0.05, mus.mean()
    assert abs(mus.std() - np.sqrt(0.2)) < 0.05, mus.std()
    assert not bool(out["divergences"].any())
    assert out["num_leapfrog"].shape == (300,)
    if static_unroll is not None:
        assert int(out["num_leapfrog"].max()) <= static_unroll


def test_chees_adapts_trajectory_to_scale():
    """On a long-correlation-length target the adapted trajectory grows
    well past its deliberately tiny initial value."""
    ys5 = iid(normal, 5)

    @gen
    def wide(h):
        mu = h.sample(normal, (0.0, 10.0), "mu")
        h.sample(ys5, (mu, 8.0), "ys")

    out = tchees.chees(1, wide, (), Trie.from_dict({"ys": torch.zeros(5)}),
                       num_samples=50, num_warmup=300, num_chains=32,
                       step_size=0.5, init_traj_length=0.5, device="cpu")
    assert float(out["trajectory_length"]) > 2.0
    mus = out["samples"]["mu"].double().numpy().ravel()
    post_prec = 1.0 / 100.0 + 5.0 / 64.0
    assert abs(mus.std() - 1.0 / np.sqrt(post_prec)) < 0.6


def test_chees_requires_multiple_chains_and_one_device(monkeypatch):
    @gen
    def m(h):
        h.sample(normal, (0.0, 1.0), "mu")

    with pytest.raises(ValueError, match="num_chains"):
        tchees.chees_runner(m, (), Trie(), num_chains=1, device="cpu")
    run = tchees.chees_runner(m, (), Trie(), axis_name="dp", device="cpu",
                              num_warmup=5, num_samples=2)
    with pytest.raises(RuntimeError, match="outside a mesh"):
        run(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obs = Trie.from_dict({"x": 1.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchees.chees_runner(conjugate, (), obs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchees.chees(0, conjugate, (), obs)
    out = tchees.chees(0, conjugate, (), obs, num_samples=2, num_warmup=2,
                       device="cpu")
    assert out["unconstrained"].device.type == "cpu"
