"""Cond, Switch and Map (``modeling/combinators.py``,
``modeling/map_combinator.py``) against the JAX package on the CPU.

Parity in float64 on the same values: fully constrained ``generate``, then
``update`` with new constraints and ``regenerate`` of a selection whose
fresh draws the port takes from the reference's trace (``pool=``); the
weights and ``logjp`` agree at 1e-12 and the discards are equal. The
models are those of ``tests/test_combinators.py`` and
``tests/test_map_combinator.py``, the Cond model with an observation
below it. Then the lane tiers: a ``Switch`` or ``Map`` run over lane keys
(the reference's ``vmap`` of runs), each lane's draws those of its key
alone, and ``Cond``'s posterior under the batched importance tier against
its closed form.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import ArgDiff as JArgDiff
from modppl_tpu import Trie as JTrie
from modppl_tpu import bernoulli as j_bernoulli
from modppl_tpu import gen as jgen
from modppl_tpu import normal as j_normal
from modppl_tpu import select as jselect
from modppl_tpu.modeling.combinators import Cond as JCond
from modppl_tpu.modeling.combinators import Switch as JSwitch
from modppl_tpu.modeling.map_combinator import Map as JMap
from modppl_tpu_torch.core.address import select
from modppl_tpu_torch.core.gfi import ArgDiff
from modppl_tpu_torch.core.keys import split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import bernoulli, normal
from modppl_tpu_torch.inference.importance import importance_sampling
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.combinators import Cond, Switch, tree_select
from modppl_tpu_torch.modeling.map_combinator import Map, PlateTrie
from _torch_threads import one_thread  # noqa: F401

F64 = torch.float64
TOL = dict(rtol=1e-12, atol=1e-12)


def t64(x):
    return torch.tensor(x, dtype=F64)


def close(port, ref):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(port)),
                               np.asarray(ref), **TOL)


# --------------------------------------------------------------------------
# the models, on both sides
# --------------------------------------------------------------------------

@gen
def t_branch(h):
    return h.sample(normal, (2.0, 0.1), "v")


@gen
def f_branch(h):
    return h.sample(normal, (-2.0, 0.1), "v")


BRANCH = Cond(t_branch, f_branch)


@gen
def cond_model(h):
    p = h.sample(bernoulli, 0.5, "p")
    v = h.trace(BRANCH, (p,), "br")
    h.sample(normal, (v, 1.0), "y")
    return v


@jgen
def j_t_branch(h):
    return h.sample(j_normal, (2.0, 0.1), "v")


@jgen
def j_f_branch(h):
    return h.sample(j_normal, (-2.0, 0.1), "v")


J_BRANCH = JCond(j_t_branch, j_f_branch)


@jgen
def j_cond_model(h):
    p = h.sample(j_bernoulli, 0.5, "p")
    v = h.trace(J_BRANCH, (p,), "br")
    h.sample(j_normal, (v, 1.0), "y")
    return v


def _const(mu, g, dist):
    @g
    def b(h):
        return h.sample(dist, (mu, 0.01), "v")
    return b


SWITCH = Switch(*(_const(mu, gen, normal) for mu in (-1.0, 0.0, 1.0)))
J_SWITCH = JSwitch(*(_const(mu, jgen, j_normal) for mu in (-1.0, 0.0, 1.0)))


@gen
def switch_model(h, idx):
    return h.trace(SWITCH, (idx,), "s")


@jgen
def j_switch_model(h, idx):
    return h.trace(J_SWITCH, (idx,), "s")


@gen
def point(h, mu, x):
    return h.sample(normal, (mu * x, 0.1), "y")


# under lane keys, xs (argument 1) is the lanes' common data
PLATE = Map(point, shared=(1,))


@gen
def regression(h, xs):
    slope = h.sample(normal, (0.0, 1.0), "slope")
    return h.trace(PLATE, (torch.as_tensor(slope)[..., None]
                           + torch.zeros_like(xs), xs), "ys")


@jgen
def j_point(h, mu, x):
    return h.sample(j_normal, (mu * x, 0.1), "y")


J_PLATE = JMap(j_point)


@jgen
def j_regression(h, xs):
    slope = h.sample(j_normal, (0.0, 1.0), "slope")
    return h.trace(J_PLATE, (jnp.full((xs.shape[0],), slope), xs), "ys")


XS = np.array([1.0, 2.0, 3.0])


# --------------------------------------------------------------------------
# Cond and Switch
# --------------------------------------------------------------------------

def _cond_obs(p, vt, vf, y, lib):
    if lib == "jax":
        return JTrie.from_dict({"p": p,
                                "br": {"true": {"v": jnp.asarray(vt)},
                                       "false": {"v": jnp.asarray(vf)}},
                                "y": jnp.asarray(y)})
    return Trie.from_dict({"p": p, "br": {"true": {"v": t64(vt)},
                                          "false": {"v": t64(vf)}},
                           "y": t64(y)})


@pytest.mark.parametrize("p", [True, False])
def test_cond_generate_update_regenerate_match_reference(p):
    jtr, jw = j_cond_model.generate(jax.random.PRNGKey(0), (),
                                    _cond_obs(p, 2.2, -1.9, 1.5, "jax"))
    tr, w = cond_model.generate(0, (), _cond_obs(p, 2.2, -1.9, 1.5, "port"),
                                device="cpu")
    close(w, jw)
    close(tr.logjp, jtr.logjp)
    close(tr.retv, jtr.retv)

    jtr2, jdis, jw2 = j_cond_model.update(
        jax.random.PRNGKey(1), jtr, (), JArgDiff.NO_CHANGE,
        JTrie.from_dict({"br": {"true": {"v": jnp.asarray(2.05)}},
                         "y": jnp.asarray(0.7)}))
    tr2, dis, w2 = cond_model.update(
        1, tr, (), ArgDiff.NO_CHANGE,
        Trie.from_dict({"br": {"true": {"v": t64(2.05)}}, "y": t64(0.7)}))
    close(w2, jw2)
    close(tr2.logjp, jtr2.logjp)
    assert dis.addresses() == [a.replace("/", " / ") for a in
                               ("br/true/v", "y")]
    for addr in ("br/true/v", "y"):
        close(dis.read(addr), jdis.read(addr))

    for sel in ("br/false/v", "br/true/v"):
        jtr3, jw3 = j_cond_model.regenerate(jax.random.PRNGKey(2), jtr2, (),
                                            JArgDiff.NO_CHANGE, jselect(sel))
        fresh = t64(float(jtr3.data.read(sel)))
        tr3, w3 = cond_model.regenerate(
            2, tr2, (), ArgDiff.NO_CHANGE, select(sel),
            pool={sel.replace("/", " / "): fresh})
        close(w3, jw3)
        close(tr3.logjp, jtr3.logjp)
        close(tr3.retv, jtr3.retv)


def test_cond_simulate_selects_the_branch():
    for key in range(6):
        tr = cond_model.simulate(key, (), device="cpu")
        p = bool(tr.data.read("p"))
        want = tr.data.read("br/true/v" if p else "br/false/v")
        assert torch.equal(tr.retv, want)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_switch_generate_matches_reference(idx):
    vals = (-0.99, 0.02, 1.01)
    jobs = JTrie.from_dict({"s": {str(i): {"v": jnp.asarray(v)}
                                  for i, v in enumerate(vals)}})
    obs = Trie.from_dict({"s": {str(i): {"v": t64(v)}
                                for i, v in enumerate(vals)}})
    jtr, jw = j_switch_model.generate(jax.random.PRNGKey(0),
                                      (jnp.asarray(idx),), jobs)
    tr, w = switch_model.generate(0, (torch.tensor(idx),), obs)
    close(w, jw)
    close(tr.logjp, jtr.logjp)
    close(tr.retv, jtr.retv)
    assert float(tr.retv) == vals[idx]


def test_switch_and_tree_select_over_lanes():
    """A (C,) index gathers each lane's branch; a (C,) predicate selects
    vector leaves by their leading axis."""
    idx = torch.tensor([0, 1, 2, 1, 0, 2, 2])
    keys = split_keys(3, idx.shape[0], "cpu")
    out = switch_model.simulate(keys, (idx,), device="cpu")
    branch = torch.stack([out.data.read(f"s/{i}/v") for i in range(3)])
    assert torch.equal(out.retv, branch[idx, torch.arange(7)])
    assert torch.allclose(out.retv, idx.to(out.retv.dtype) - 1.0, atol=0.05)

    pred = torch.tensor([True, False, True])
    a = {"x": torch.zeros(3, 4), "y": torch.zeros(3)}
    b = {"x": torch.ones(3, 4), "y": torch.ones(3)}
    got = tree_select(pred, a, b)
    assert torch.equal(got["x"][:, 0], torch.tensor([0.0, 1.0, 0.0]))
    assert torch.equal(got["y"], torch.tensor([0.0, 1.0, 0.0]))
    assert tree_select(False, a, b) is b


def test_cond_posterior_under_batched_importance():
    """p ~ bernoulli(0.5), v from Cond(N(2, 0.1), N(-2, 0.1)), y ~ N(v, 1)
    observed at 1.5: P(p | y) within 4 Monte Carlo standard errors of its
    closed form."""
    n = 1 << 15
    obs = Trie.from_dict({"y": 1.5})
    traces, lw, _ = importance_sampling(1, cond_model, (), obs, n,
                                        device="cpu")
    w = torch.exp(lw).double()
    p = traces.data.read("p").double()
    est = float(torch.sum(w * p))
    s = math.sqrt(1.01)
    f = [math.exp(-0.5 * ((1.5 - mu) / s) ** 2) for mu in (2.0, -2.0)]
    exact = f[0] / (f[0] + f[1])
    ess = 1.0 / float(torch.sum(w * w))
    se = math.sqrt(exact * (1 - exact) / ess)
    assert abs(est - exact) < 4 * se + 1e-6
    assert traces.retv.shape == (n,)


# --------------------------------------------------------------------------
# Map
# --------------------------------------------------------------------------

def test_map_generate_update_regenerate_match_reference():
    xs, jxs = t64(XS), jnp.asarray(XS)
    obs = {"slope": 0.5, "ys": {"y": [0.5, 1.0, 1.5]}}
    jtr, jw = j_regression.generate(
        jax.random.PRNGKey(2), (jxs,),
        JTrie.from_dict({"slope": jnp.asarray(0.5),
                         "ys": {"y": jnp.asarray(obs["ys"]["y"])}}))
    tr, w = regression.generate(
        2, (xs,), Trie.from_dict({"slope": t64(0.5),
                                  "ys": {"y": t64(obs["ys"]["y"])}}))
    close(w, jw)
    close(tr.logjp, jtr.logjp)
    close(tr.retv, jtr.retv)
    assert isinstance(tr.data.search("ys"), PlateTrie)

    new = [0.6, 1.0, 1.5]
    jtr2, jdis, jw2 = j_regression.update(
        jax.random.PRNGKey(3), jtr, (jxs,), JArgDiff.NO_CHANGE,
        JTrie.from_dict({"ys": {"y": jnp.asarray(new)}}))
    tr2, dis, w2 = regression.update(
        3, tr, (xs,), ArgDiff.NO_CHANGE,
        Trie.from_dict({"ys": {"y": t64(new)}}))
    close(w2, jw2)
    close(tr2.logjp, jtr2.logjp)
    close(tr2.data.read("ys/y"), jtr2.data.read("ys/y"))
    close(dis.read("ys/y"), jdis.read("ys/y"))

    for sel in ("ys/y", "slope"):
        jtr3, jw3 = j_regression.regenerate(
            jax.random.PRNGKey(4), jtr2, (jxs,), JArgDiff.NO_CHANGE,
            jselect(sel))
        fresh = torch.from_numpy(np.array(jtr3.data.read(sel)))
        tr3, w3 = regression.regenerate(
            4, tr2, (xs,), ArgDiff.NO_CHANGE, select(sel),
            pool={sel.replace("/", " / "): fresh})
        close(w3, jw3)
        close(tr3.logjp, jtr3.logjp)
        close(tr3.data.read("ys/y"), jtr3.data.read("ys/y"))


def test_map_simulate_scores_every_element():
    """tests/test_map_combinator.py:27-37 on the port's own draws."""
    xs = t64(XS)
    tr = regression.simulate(0, (xs,))
    ys, slope = tr.data.read("ys/y"), tr.data.read("slope")
    assert ys.shape == (3,)
    want = float(normal.logpdf(slope, (0.0, 1.0))) + sum(
        float(normal.logpdf(ys[i], (slope * xs[i], 0.1))) for i in range(3))
    assert float(tr.logjp) == pytest.approx(want, rel=1e-12)


def test_map_in_a_lane_batched_model():
    """tests/test_map_combinator.py:66-69: 7 runs as lanes, retv (7, 3);
    each lane's run is the one its key gives alone."""
    xs = t64(XS)
    keys = split_keys(5, 7, "cpu")
    out = regression.simulate(keys, (xs,))
    assert out.retv.shape == (7, 3) and out.logjp.shape == (7,)
    assert out.data.read("ys/y").shape == (7, 3)
    for c in (0, 4):
        one = regression.simulate(keys[c:c + 1], (xs,))
        assert torch.equal(one.retv[0], out.retv[c])
        assert torch.equal(one.logjp[0], out.logjp[c])
    slope = out.data.read("slope")
    want = normal.logpdf(slope, (0.0, 1.0)) + torch.sum(normal.logpdf(
        out.retv, (slope[:, None] * xs, 0.1)), -1)
    torch.testing.assert_close(out.logjp, want, rtol=1e-12, atol=1e-12)


@gen
def dot_point(h, w, x):
    return h.sample(normal, (torch.sum(w * x, -1), 0.1), "y")


@gen
def dot_point_xw(h, x, w):
    return h.sample(normal, (torch.sum(w * x, -1), 0.1), "y")


def test_map_shared_args_are_stated_not_read_from_shapes():
    """Three lanes over a plate of three: a shared (n, 2) argument has the
    shape of a per-lane one, so only ``shared=`` tells them apart. Lane c's
    element j meets row j of the shared x, whichever argument comes first;
    left undeclared, x is per lane and its (3, 2) shape raises."""
    rng = np.random.default_rng(6)
    w, x = t64(rng.standard_normal((3, 3, 2))), t64(rng.standard_normal(
        (3, 2)))
    keys = split_keys(8, 3, "cpu")
    plate = Map(dot_point, shared=(1,))
    tr = plate.simulate(keys, (w, x))
    assert tr.retv.shape == (3, 3) and tr.logjp.shape == (3,)
    for c in range(3):
        one = plate.simulate(keys[c:c + 1], (w[c:c + 1], x))
        assert torch.equal(one.retv[0], tr.retv[c])
    want = torch.sum(normal.logpdf(tr.retv, (torch.sum(w * x, -1), 0.1)), -1)
    torch.testing.assert_close(tr.logjp, want, rtol=1e-12, atol=1e-12)
    flipped = Map(dot_point_xw, shared=(0,)).simulate(keys, (x, w))
    assert torch.equal(flipped.retv, tr.retv)
    with pytest.raises(ValueError, match=r"not per lane \(3, 3, \.\.\.\)"):
        Map(dot_point).simulate(keys, (w, x))
    with pytest.raises(ValueError, match=r"not shared \(3, \.\.\.\)"):
        plate.simulate(keys, (w, x[:2]))
