"""NUTS, port vs reference (CPU, float64), and the reference's gates.

``nuts_transition`` is held to the JAX package's on the reference's own
draws: the test splits each chain's key as ``modppl_tpu/inference/nuts.py``
does (momenta from ``split(key)[0]``, then per depth ``split(key, 4)``: the
direction, ``fold_in(k_sub, i)`` for leaf i and the take uniform) and
hands the port those numbers. The runners are held on the same draws over
short runs; the statistical gates are ``tests/test_nuts.py``'s, at its
bounds.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from modppl_tpu import Trie as JTrie
from modppl_tpu import gen as jgen
from modppl_tpu import normal as jnormal
from modppl_tpu.dists.iid import iid as jiid
from modppl_tpu.models import hierarchical_static as jhs
from modppl_tpu_torch.core.keys import fold_in, lanes, split, split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import iid, normal
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models import hierarchical_static as ths
from _torch_threads import one_thread  # noqa: F401

# the package exports the functions hmc and nuts; the modules by path
thmc = importlib.import_module("modppl_tpu_torch.inference.hmc")
tnuts = importlib.import_module("modppl_tpu_torch.inference.nuts")

jnuts = importlib.import_module("modppl_tpu.inference.nuts")
jhmc = importlib.import_module("modppl_tpu.inference.hmc")

STATE_TOL = dict(rtol=1e-12, atol=1e-12)


# the reference tests' models, on both sides

@jgen
def j_conjugate(h):
    mu = h.sample(jnormal, (0.0, 1.0), "mu")
    h.sample(jnormal, (mu, 1.0), "x")


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")


@jgen
def j_linreg(h, xs):
    slope = h.sample(jnormal, (0.0, 1.0), "slope")
    intercept = h.sample(jnormal, (0.0, 2.0), "intercept")
    h.sample(jiid(jnormal, 11), (slope * xs + intercept, 0.1), "ys")


@gen
def linreg(h, xs):
    slope = h.sample(normal, (0.0, 1.0), "slope")
    intercept = h.sample(normal, (0.0, 2.0), "intercept")
    h.sample(iid(normal, 11), (slope * xs + intercept, 0.1), "ys")


@jgen
def j_funnel(h):
    v = h.sample(jnormal, (0.0, 3.0), "v")
    h.sample(jiid(jnormal, 4), (0.0, jnp.exp(0.5 * v)), "x")


@gen
def funnel(h):
    v = h.sample(normal, (0.0, 3.0), "v")
    h.sample(iid(normal, 4), (0.0, torch.exp(0.5 * v)), "x")


def _linreg_data():
    xs = np.linspace(-5.0, 5.0, 11)
    return xs, 0.5 * xs - 1.0


def _hier_data():
    xs = np.linspace(-1.0, 1.0, 10)
    ys = 0.3 + 0.5 * xs - 0.8 * xs * xs + 0.1 * np.random.default_rng(
        0).standard_normal(10)
    return xs, ys


def _targets(name):
    """(reference model, args, obs; port model, args, obs)."""
    if name == "conjugate":
        return (j_conjugate, (), JTrie.from_dict({"x": 1.0}), conjugate, (),
                Trie.from_dict({"x": torch.tensor(1.0, dtype=torch.float64)}))
    if name == "linreg":
        xs, ys = _linreg_data()
        return (j_linreg, (jnp.asarray(xs),),
                JTrie.from_dict({"ys": jnp.asarray(ys)}), linreg,
                (tensor(xs),), Trie.from_dict({"ys": tensor(ys)}))
    if name == "funnel":
        return j_funnel, (), JTrie(), funnel, (), Trie()
    xs, ys = _hier_data()
    return (jhs.make_hierarchical_static(10), (jnp.asarray(xs),),
            JTrie.from_dict({"ys": jnp.asarray(ys), "is_linear": False}),
            ths.make_hierarchical_static(10), (tensor(xs),),
            Trie.from_dict({"ys": tensor(ys), "is_linear": False}))


def _flat(name):
    """(reference logprob, port logprob, dim) on flat coordinates."""
    jm, ja, jo, tm, ta, to = _targets(name)
    tr, _ = jm.generate(jax.random.PRNGKey(0), ja, jo)
    lp, u0, _, _ = jhmc.make_unconstrained_logprob(jm, ja, tr, jo)
    _, unravel = ravel_pytree(u0)
    ttr, _ = tm.generate(0, ta, to, device="cpu")
    target = thmc.flat_target(tm, ta, ttr, to, device="cpu")
    return (lambda u: lp(unravel(u))), target.logprob, target.u0.shape[0]


@functools.lru_cache(maxsize=None)
def _draws_fn(d, max_depth):
    """Each chain's transition draws, split from its key as the reference
    splits it (compiled once a shape)."""
    def one(k):
        k_mom, key = jax.random.split(k)
        z = jax.random.normal(k_mom, (d,), jnp.float64)
        per_depth = []
        for j in range(max_depth):
            k_dir, k_sub, k_take, key = jax.random.split(key, 4)
            leaves = jax.vmap(lambda i: jax.random.uniform(
                jax.random.fold_in(k_sub, i), (), jnp.float64))(
                    jnp.arange(1 << j, dtype=jnp.int32))
            per_depth.append((jax.random.bernoulli(k_dir),
                              jax.random.uniform(k_take, (), jnp.float64),
                              leaves))
        return z, per_depth

    return jax.jit(jax.vmap(one))


def _ref_draws(keys, d, max_depth):
    """The reference's draws for ``keys`` in the port's ``draws=`` layout."""
    z, per_depth = _draws_fn(d, max_depth)(keys)
    return tensor(z), [tuple(tensor(x) for x in d) for d in per_depth]


def _ref_transition(lp, per_chain, max_depth):
    """The reference's transition vmapped over chains, compiled once."""
    grad = jax.grad(lp)
    axis = 0 if per_chain else None
    return jax.jit(jax.vmap(lambda k, u, e, m: jnuts.nuts_transition(
        k, u, lp, grad, e, m, max_depth), in_axes=(0, 0, axis, axis)))


CASES = {
    # name: (eps, per-chain step sizes and masses, start centre, start
    # spread, mass scale): the starts near each posterior, so that the
    # trees grow to several depths
    "conjugate": (0.3, False, 0.5, 1.0, 1.0),
    "linreg": (0.3, True, (0.5, -1.0), 0.02, 1e-3),
    "funnel": (1.5, False, 0.0, 1.0, 1.0),
    "hierarchical": (0.3, True, (0.3, 0.5, -0.8), 0.05, 3e-3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nuts_transition_matches_reference(name):
    lp, tlp, d = _flat(name)
    eps0, per_chain, centre, spread, mass = CASES[name]
    c, max_depth = 32, 6
    rng = np.random.default_rng(3)
    us = np.asarray(centre) + spread * rng.standard_normal((c, d))
    if per_chain:
        eps = eps0 * (0.5 + rng.random(c))
        inv_mass = mass * (0.5 + rng.random((c, d)))
    else:
        eps, inv_mass = np.float64(eps0), mass * (0.5 + rng.random(d))
    vag = thmc._value_and_grad(tlp)
    ref = _ref_transition(lp, per_chain, max_depth)
    t_us = tensor(us)
    divergent = 0
    for step in range(3):
        keys = jax.random.split(jax.random.PRNGKey(10 + step), c)
        want_u, want_lp, want = ref(keys, jnp.asarray(us), jnp.asarray(eps),
                                    jnp.asarray(inv_mass))
        got_u, got_lp, got = tnuts.nuts_transition(
            None, t_us, vag, tensor(eps), tensor(inv_mass), max_depth,
            draws=_ref_draws(keys, d, max_depth))
        np.testing.assert_allclose(got_u.numpy(), want_u, **STATE_TOL)
        np.testing.assert_allclose(got_lp.numpy(), want_lp, **STATE_TOL)
        np.testing.assert_allclose(got["accept_prob"].numpy(),
                                   want["accept_prob"], **STATE_TOL)
        for k in ("divergent", "tree_depth", "num_leapfrog"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        divergent += int(np.sum(want["divergent"]))
        us, t_us = np.asarray(want_u), tensor(np.asarray(want_u))
    if name == "funnel":
        assert divergent > 0  # step size 1.5: the guard fires


# --------------------------------------------------------------------------
# The runners on the reference's draws
# --------------------------------------------------------------------------

CHAIN_TOL = dict(rtol=1e-9, atol=1e-9)
# warmup + samples at which the two sides' chains stay equal: every phase of
# the schedule (10 fast, one slow window of 10, 10 fast), then sampling
RUN = dict(num_warmup=30, num_samples=10, eps0=0.1, max_depth=5,
           target_accept=0.8)


def _fold_lanes(k, c):
    return jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(c))


def _pooled_keys(key, c):
    """The reference pooled path's keys, one (C,) set a transition."""
    from modppl_tpu_torch.inference.adaptation import warmup_phases

    wk = jax.random.fold_in(key, 0)
    out = []
    for phase, (length, _) in enumerate(warmup_phases(RUN["num_warmup"])):
        out += [_fold_lanes(k, c) for k in jax.random.split(
            jax.random.fold_in(wk, phase), length)]
    out += [_fold_lanes(k, c) for k in jax.random.split(
        jax.random.fold_in(key, 2), RUN["num_samples"])]
    return out


def _chain_keys(chain_keys):
    """The reference per-chain path's keys, one (C,) set a transition."""
    from modppl_tpu_torch.inference.adaptation import warmup_phases

    def one(kc):
        wk = jax.random.fold_in(kc, 0)
        ks = [jax.random.split(jax.random.fold_in(wk, phase), length)
              for phase, (length, _) in enumerate(
                  warmup_phases(RUN["num_warmup"]))]
        ks.append(jax.random.split(jax.random.fold_in(kc, 2),
                                   RUN["num_samples"]))
        return jnp.concatenate(ks)

    per_chain = jax.vmap(one)(chain_keys)
    return [per_chain[:, t] for t in range(per_chain.shape[1])]


@pytest.mark.parametrize("pooled", [True, False], ids=["pooled", "per_chain"])
def test_nuts_chains_match_reference(pooled):
    lp, tlp, d = _flat("hierarchical")
    c = 8
    rng = np.random.default_rng(5)
    u0s = np.array([0.3, 0.5, -0.8]) + 0.3 * rng.standard_normal((c, d))
    key = jax.random.PRNGKey(21)
    args = (RUN["num_warmup"], RUN["num_samples"], RUN["eps0"],
            RUN["max_depth"], RUN["target_accept"])
    if pooled:
        want = jnuts._pooled_nuts_chains(key, lp, jnp.asarray(u0s), *args)
        keys = _pooled_keys(key, c)
        got = tnuts._pooled_nuts_chains(
            0, tlp, tensor(u0s), *args,
            draws=[_ref_draws(k, d, RUN["max_depth"]) for k in keys])
    else:
        chain_keys = jax.random.split(key, c)
        want = jax.vmap(lambda k, u: jnuts._nuts_chain(
            k, lp, u, *args))(chain_keys, jnp.asarray(u0s))
        keys = _chain_keys(chain_keys)
        got = tnuts._nuts_chain(
            split_keys(0, c, "cpu"), tlp, tensor(u0s), *args,
            draws=[_ref_draws(k, d, RUN["max_depth"]) for k in keys])
    us, logps, aprobs, divs, depths, eps = got
    np.testing.assert_allclose(us.numpy(), want[0], **CHAIN_TOL)
    np.testing.assert_allclose(logps.numpy(), want[1], **CHAIN_TOL)
    np.testing.assert_allclose(aprobs.numpy(), want[2], **CHAIN_TOL)
    np.testing.assert_array_equal(divs.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(depths.numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(eps.numpy(), want[5], **CHAIN_TOL)
    assert depths.numpy().max() > 1
