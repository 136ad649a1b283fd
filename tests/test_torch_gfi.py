"""The port's GFI core against the reference's (CPU, float64).

Every constant and error of tests/test_gfi_regression.py, on the same models
written in the port's DSL; the Trie and Selection cases of tests/test_trie.py
and tests/test_address.py; the new scalar distributions' log-densities
against the JAX functions on seeded numpy inputs; and ``update`` /
``regenerate`` on the same traces with the reference's draws injected, which
must give the reference's weights and discards.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import ArgDiff as JArgDiff
from modppl_tpu import Trie as JTrie
from modppl_tpu import gen as jgen
from modppl_tpu import select as jselect
from modppl_tpu.dists import bernoulli as j_bernoulli
from modppl_tpu.dists import beta as j_beta
from modppl_tpu.dists import gamma as j_gamma
from modppl_tpu.dists import geometric as j_geometric
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.dists import poisson as j_poisson
from modppl_tpu.dists import uniform as j_uniform
from modppl_tpu.dists import uniform_discrete as j_uniform_discrete
from modppl_tpu.modeling.handlers import addr_subkey
from modppl_tpu_torch.core import ArgDiff, Selection, Trie, select
from modppl_tpu_torch.core.address import normalize_addr, split_addr
from modppl_tpu_torch.core.keys import generator
from modppl_tpu_torch.dists import (
    bernoulli,
    beta,
    gamma,
    geometric,
    normal,
    poisson,
    uniform,
    uniform_discrete,
)
from modppl_tpu_torch.inference.mcmc import (
    mcmc_chain,
    mh_kernel,
    regen_mh_kernel,
    tree_select,
)
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.autobatch import AutoBatchedStep
from _torch_threads import one_thread  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def float64_default():
    """The reference runs with x64: the port's default float follows."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def t(v):
    return torch.tensor(v)


def trie_of(**kwargs):
    tr = Trie()
    for k, v in kwargs.items():
        tr.observe(k, t(v))
    return tr


def jtrie_of(**kwargs):
    tr = JTrie()
    for k, v in kwargs.items():
        tr.observe(k, jnp.asarray(v))
    return tr


# --- models (tests/test_gfi_regression.py:26-56) ---------------------------

@gen
def branch_normal(h):
    b = h.sample(bernoulli, 0.25, "b")
    if b:
        h.sample(normal, (0.0, 1.0), "x")


@gen
def sub_normal(h, noise):
    return h.sample(normal, (1.0, noise), "s")


@gen
def branch_traced(h):
    b = h.sample(bernoulli, 0.25, "b")
    if b:
        h.trace(sub_normal, (1.0,), "sub")


@gen
def m_model(h):
    m = h.sample(uniform, (0.0, 1.0), "m")
    h.sample(normal, (m, 1.0), "x")
    h.sample(normal, (m, 1.0), "y")


@gen
def bar(h):
    return h.sample(normal, (0.0, 1.0), "a")


@gen
def baz(h):
    return h.sample(normal, (0.0, 1.0), "b")


@gen
def foo_branch(h):
    if h.sample(bernoulli, 0.4, "branch"):
        h.sample(normal, (0.0, 1.0), "x")
        return h.trace(bar, (), "u")
    h.sample(normal, (0.0, 1.0), "y")
    return h.trace(baz, (), "v")


# --- update weight regressions (tests/test_gfi_regression.py:61-100) -------

def test_sample_at_update_prev_and_constrained():
    tr, _ = branch_normal.generate(0, (), trie_of(b=True, x=0.0), device=CPU)
    _, _, w = branch_normal.update(1, tr, (), ArgDiff.UNKNOWN, trie_of(x=1.0))
    assert float(w) == pytest.approx(-0.5)


def test_sample_at_update_no_prev_and_constrained():
    tr, _ = branch_normal.generate(0, (), trie_of(b=False), device=CPU)
    _, _, w = branch_normal.update(1, tr, (), ArgDiff.UNKNOWN,
                                   trie_of(b=True, x=1.0))
    assert float(w) == pytest.approx(-2.517551, abs=1e-6)


def test_update_sample_at_prev_and_unconstrained():
    tr, _ = m_model.generate(0, (), trie_of(m=1.0, x=1.0, y=-0.3),
                             device=CPU)
    _, _, w = m_model.update(1, tr, (), ArgDiff.UNKNOWN, trie_of(m=0.5))
    assert float(w) == pytest.approx(0.4, abs=1e-6)


def test_update_no_prev_and_unconstrained():
    tr, _ = branch_normal.generate(0, (), trie_of(b=False), device=CPU)
    _, _, w = branch_normal.update(1, tr, (), ArgDiff.UNKNOWN,
                                   trie_of(b=True))
    assert float(w) == pytest.approx(-1.098612, abs=1e-6)
    tr, _ = branch_traced.generate(0, (), trie_of(b=False), device=CPU)
    _, _, w = branch_traced.update(1, tr, (), ArgDiff.UNKNOWN,
                                   trie_of(b=True))
    assert float(w) == pytest.approx(-1.098612, abs=1e-6)


def test_generate_residual_constraints_raises():
    with pytest.raises(ValueError, match="residual"):
        m_model.generate(0, (), trie_of(abc=0.0), device=CPU)


def test_update_residual_constraints_raises():
    tr = m_model.simulate(0, (), device=CPU)
    with pytest.raises(ValueError, match="residual"):
        m_model.update(1, tr, (), ArgDiff.NO_CHANGE, trie_of(abc=0.0))


def test_simulate_call_propose_assess():
    @gen
    def foo(h, p):
        return h.sample(bernoulli, p, "x")

    p = 0.4
    trace = foo.simulate(7, (p,), device=CPU)
    assert bool(trace.data.read("x")) == bool(trace.retv)
    assert trace.args == (p,)
    expected = math.log(p) if bool(trace.data.read("x")) else math.log(1 - p)
    assert float(trace.logjp) == pytest.approx(expected)
    assert bool(foo.call(7, (p,), device=CPU)) == bool(trace.retv)
    choices, logjp = foo.propose(7, (p,), device=CPU)
    assert choices == trace.data and float(logjp) == float(trace.logjp)
    assert float(foo.assess(1, (p,), choices, device=CPU)) == float(logjp)


# --- update with a branch switch, and the GC (:140-201) --------------------

def test_update_branch_switch():
    trace, _ = foo_branch.generate(3, (), trie_of(branch=True), device=CPU)
    x = trace.data.read("x")
    a = trace.data.read("u/a")
    y, b = 1.123, -2.1
    constraints = Trie()
    constraints.observe("branch", t(False))
    constraints.observe("y", t(y))
    constraints.observe("v/b", t(b))
    new_trace, discard, weight = foo_branch.update(
        4, trace, (), ArgDiff.NO_CHANGE, constraints)

    assert bool(discard.read("branch")) is True
    assert float(discard.read("x")) == float(x)
    assert float(discard.read("u/a")) == float(a)
    leaves = sum(1 for _, s in discard if s.is_leaf())
    assert (leaves, len(discard) - leaves) == (2, 1)

    data = new_trace.data
    assert bool(data.read("branch")) is False
    assert float(data.read("y")) == y
    assert float(data.read("v/b")) == b
    leaves = sum(1 for _, s in data if s.is_leaf())
    assert (leaves, len(data) - leaves) == (2, 1)

    def nlp(v, mu, std):
        return float(normal.logpdf(t(float(v)), (mu, std)))

    prev_logjp = (float(bernoulli.logpdf(t(True), 0.4)) + nlp(x, 0, 1)
                  + nlp(a, 0, 1))
    expected_new = (float(bernoulli.logpdf(t(False), 0.4)) + nlp(y, 0, 1)
                    + nlp(b, 0, 1))
    assert float(new_trace.logjp) == pytest.approx(expected_new, abs=1e-3)
    assert float(weight) == pytest.approx(expected_new - prev_logjp,
                                          abs=1e-3)
    # the caller's trace is untouched
    assert bool(trace.data.read("branch")) and trace.data.search("u")


def test_update_visited_namespace_not_discarded():
    @gen
    def loopy(h):
        a = h.sample(normal, (0.0, 1.0), "a")
        for i in range(5):
            h.sample(normal, (a, 1.0), f"data/{i}")

    constraints = trie_of(a=0.0)
    for i in range(5):
        constraints.observe(f"data/{i}", t(0.0))
    trace, _ = loopy.generate(5, (), constraints, device=CPU)
    new_trace, discard, weight = loopy.update(6, trace, (), ArgDiff.NO_CHANGE,
                                              trie_of(a=1.0))
    assert float(discard.read("a")) == 0.0
    assert discard.addresses() == ["a"]
    prev = 6.0 * normal.logpdf(0.0, (0.0, 1.0))
    new = normal.logpdf(1.0, (0.0, 1.0)) + 5.0 * normal.logpdf(0.0, (1.0, 1.0))
    assert float(new_trace.logjp) == pytest.approx(new, abs=1e-3)
    assert float(weight) == pytest.approx(new - prev, abs=1e-3)


def test_update_poisson_ranged_loop():
    @gen
    def hierarchical_update(h):
        k = h.sample(poisson, 5.0, "k")
        for i in range(int(k)):
            h.sample(uniform, (0.0, 1.0), f"value/{i}")

    trace, _ = hierarchical_update.generate(8, (), trie_of(k=3), device=CPU)
    _, discard, weight = hierarchical_update.update(
        9, trace, (), ArgDiff.UNKNOWN, trie_of(k=1))
    assert discard.search("value/1") is not None
    assert discard.search("value/2") is not None
    expected = (float(poisson.logpdf(1, 5.0)) - float(poisson.logpdf(3, 5.0))
                - 2.0 * float(uniform.logpdf(t(0.5), (0.0, 1.0))))
    assert float(weight) == pytest.approx(expected)


# --- regenerate (:224-304) -------------------------------------------------

def test_regenerate():
    @gen
    def bar_mu(h, mu):
        return h.sample(normal, (mu, 1.0), "a")

    @gen
    def baz_mu(h, mu):
        return h.sample(normal, (mu, 1.0), "b")

    @gen
    def foo(h, mu):
        if h.sample(bernoulli, 0.4, "branch"):
            h.sample(normal, (mu, 1.0), "x")
            return h.trace(bar_mu, (mu,), "u")
        h.sample(normal, (mu, 1.0), "y")
        return h.trace(baz_mu, (mu,), "v")

    mu = 0.123
    trace, _ = foo.generate(10, (mu,), trie_of(branch=True), device=CPU)
    mask = select("branch")
    rng = np.random.default_rng(11)
    switched = 0
    for i in range(10):
        prev_branch = bool(trace.data.read("branch"))
        prev_mu = mu
        mu = float(rng.uniform())
        trace, weight = foo.regenerate(100 + i, trace, (mu,),
                                       ArgDiff.UNKNOWN, mask)
        branch = bool(trace.data.read("branch"))
        switched += branch != prev_branch

        def nlp(addr, m):
            return float(normal.logpdf(trace.data.read(addr), (m, 1.0)))

        first, second = ("x", "u/a") if branch else ("y", "v/b")
        expected = nlp(first, mu) + nlp(second, mu) + float(
            bernoulli.logpdf(t(branch), 0.4))
        assert float(trace.logjp) == pytest.approx(expected, abs=1e-3)
        assert trace.data.search(first) is not None
        assert not trace.data.search(second.split("/")[0]).is_leaf()
        leaves = sum(1 for _, s in trace.data if s.is_leaf())
        assert (leaves, len(trace.data) - leaves) == (2, 1)
        want = 0.0
        if branch == prev_branch:
            want = (nlp(first, mu) + nlp(second, mu) - nlp(first, prev_mu)
                    - nlp(second, prev_mu))
        assert float(weight) == pytest.approx(want, abs=1e-3)
    assert switched > 0


def test_regenerate_empty_mask_means_all():
    @gen
    def two(h):
        h.sample(normal, (0.0, 1.0), "p")
        h.sample(normal, (0.0, 1.0), "q")

    tr = two.simulate(20, (), device=CPU)
    p0, q0 = float(tr.data.read("p")), float(tr.data.read("q"))
    new_tr, w = two.regenerate(21, tr, (), ArgDiff.NO_CHANGE, select())
    assert float(new_tr.data.read("p")) != p0
    assert float(new_tr.data.read("q")) != q0
    assert float(w) == pytest.approx(0.0)


def test_hierarchical_addresses():
    @gen
    def hyperprior(h, a, b):
        p = h.sample(beta, (a, b), "prob_is_small")
        return h.sample(bernoulli, p, "is_small")

    @gen
    def model(h):
        if h.trace(hyperprior, (2.0, 2.0), "var"):
            return h.sample(normal, (0.0, 0.05), "y")
        return h.sample(normal, (0.0, 1.0), "y")

    tr = model.simulate(30, (), device=CPU)
    assert tr.data.search("var/prob_is_small") is not None
    assert tr.data.search("var / is_small") is not None
    assert tr.data.search("y") is not None
    assert tr.data.search("var").inner() is not None  # the sub-call's retv


def test_factor_in_every_mode():
    """A factor adds to logjp in every mode and to the weight of generate,
    update and regenerate, as in the reference."""
    def body(dist):
        def fn(h, c):
            m = h.sample(dist, (0.0, 1.0), "m")
            h.factor(-0.5 * (m - c) * (m - c), "soft")
            return m
        return fn

    port, ref = gen(body(normal)), jgen(body(j_normal))
    tr, w = port.generate(0, (t(0.3),), trie_of(m=0.7))
    jtr, jw = ref.generate(jax.random.PRNGKey(0), (jnp.asarray(0.3),),
                           jtrie_of(m=0.7))
    assert float(w) == pytest.approx(float(jw), abs=1e-12)
    assert float(tr.logjp) == pytest.approx(float(jtr.logjp), abs=1e-12)
    sim = port.simulate(1, (t(0.3),))
    assert float(sim.logjp) == pytest.approx(
        float(sim.data.search("m").logp + sim.data.search("soft").logp))
    new, _, w = port.update(2, tr, (t(-0.4),), ArgDiff.UNKNOWN,
                            trie_of(m=0.1))
    jnew, _, jw = ref.update(jax.random.PRNGKey(2), jtr, (jnp.asarray(-0.4),),
                             JArgDiff.UNKNOWN, jtrie_of(m=0.1))
    assert float(w) == pytest.approx(float(jw), abs=1e-12)
    assert float(new.logjp) == pytest.approx(float(jnew.logjp), abs=1e-12)
    _, w = port.regenerate(3, tr, (t(-0.4),), ArgDiff.UNKNOWN,
                           select("soft"))
    _, jw = ref.regenerate(jax.random.PRNGKey(3), jtr, (jnp.asarray(-0.4),),
                           JArgDiff.UNKNOWN, jselect("soft"))
    assert float(w) == pytest.approx(float(jw), abs=1e-12)


# --- update / regenerate with the reference's draws injected ---------------

def _jbranch_normal(h):
    b = h.sample(j_bernoulli, 0.25, "b")
    if b:
        h.sample(j_normal, (0.0, 1.0), "x")


def _jm_model(h):
    m = h.sample(j_uniform, (0.0, 1.0), "m")
    h.sample(j_normal, (m, 1.0), "x")
    h.sample(j_normal, (m, 1.0), "y")


def _reference_pool(key, sites):
    """What the reference's handler draws at each (addr, dist, params)."""
    return {a: tensor(np.asarray(d.sample(addr_subkey(key, a), p)))
            for a, d, p in sites}


def _as_numpy(trie):
    return {a: np.asarray(trie[a]) for a in trie.addresses()
            if not isinstance(trie[a], tuple)}


def _same_trie(port, ref):
    assert port.addresses() == ref.addresses()
    for a, v in _as_numpy(ref).items():
        np.testing.assert_array_equal(np.asarray(port[a]), v)


@pytest.mark.parametrize("seed", range(4))
def test_regenerate_matches_reference_on_its_draws(seed):
    """branch_normal regenerated at "b" (a branch switch brings "x" in or
    drops it) and m_model at "m": the reference's draws injected, weights
    within 1e-12 and the same choices."""
    jb, jm = jgen(_jbranch_normal), jgen(_jm_model)
    for b0 in (True, False):
        init = dict(b=b0, x=0.3) if b0 else dict(b=b0)
        tr, _ = branch_normal.generate(0, (), trie_of(**init), device=CPU)
        jtr, _ = jb.generate(jax.random.PRNGKey(0), (), jtrie_of(**init))
        key = jax.random.PRNGKey(seed)
        pool = _reference_pool(key, [("b", j_bernoulli, 0.25),
                                     ("x", j_normal, (0.0, 1.0))])
        new, w = branch_normal.regenerate(seed, tr, (), ArgDiff.NO_CHANGE,
                                          select("b"), pool=pool)
        jnew, jw = jb.regenerate(key, jtr, (), JArgDiff.NO_CHANGE,
                                 jselect("b"))
        assert float(w) == pytest.approx(float(jw), abs=1e-12)
        _same_trie(new.data, jnew.data)
        assert float(new.logjp) == pytest.approx(float(jnew.logjp),
                                                 abs=1e-12)
    tr, _ = m_model.generate(0, (), trie_of(m=0.2, x=1.0, y=-0.3),
                             device=CPU)
    jtr, _ = jgen(_jm_model).generate(jax.random.PRNGKey(0), (),
                                      jtrie_of(m=0.2, x=1.0, y=-0.3))
    key = jax.random.PRNGKey(10 + seed)
    pool = _reference_pool(key, [("m", j_uniform, (0.0, 1.0))])
    new, w = m_model.regenerate(seed, tr, (), ArgDiff.NO_CHANGE, select("m"),
                                pool=pool)
    jnew, jw = jm.regenerate(key, jtr, (), JArgDiff.NO_CHANGE, jselect("m"))
    assert float(w) == pytest.approx(float(jw), abs=1e-12)
    _same_trie(new.data, jnew.data)


@pytest.mark.parametrize("seed", range(3))
def test_update_matches_reference_on_its_draws(seed):
    """update through a branch switch both ways, the new address drawn from
    the reference's stream: weights within 1e-12, identical discards."""
    jb = jgen(_jbranch_normal)
    cases = [(dict(b=False), dict(b=True)), (dict(b=True, x=0.7),
                                             dict(b=False)),
             (dict(b=True, x=0.7), dict(x=-1.2))]
    for init, cons in cases:
        tr, _ = branch_normal.generate(0, (), trie_of(**init), device=CPU)
        jtr, _ = jb.generate(jax.random.PRNGKey(0), (), jtrie_of(**init))
        key = jax.random.PRNGKey(seed)
        pool = _reference_pool(key, [("x", j_normal, (0.0, 1.0))])
        new, discard, w = branch_normal.update(
            seed, tr, (), ArgDiff.UNKNOWN, trie_of(**cons), pool=pool)
        jnew, jdiscard, jw = jb.update(key, jtr, (), JArgDiff.UNKNOWN,
                                       jtrie_of(**cons))
        assert float(w) == pytest.approx(float(jw), abs=1e-12)
        _same_trie(new.data, jnew.data)
        _same_trie(discard, jdiscard)


# --- Trie and Selection (tests/test_trie.py, tests/test_address.py) --------

def test_trie_insert_remove_search_weight():
    tr = Trie()
    tr.observe("a/b/c", 1.0)
    sub = tr.remove("a/b/c")
    assert sub.is_leaf() and sub.inner() == 1.0 and tr.is_empty()
    tr.w_observe("x", 1.0, -0.5)
    tr.w_observe("a / b", 2.0, -1.5)
    assert tr.search("a/b").inner() == 2.0 and tr.read("a/b") == 2.0
    assert float(tr.weight()) == pytest.approx(-2.0)
    sub = tr.remove("a")
    assert float(tr.weight()) == pytest.approx(-0.5)
    assert float(sub.weight()) == pytest.approx(-1.5)
    with pytest.raises(KeyError):
        tr.observe("x", 2.0)
    with pytest.raises(KeyError):
        tr.insert("x", Trie.leaf(3.0))
    tr["z"] = 4.0
    assert tr["z"] == 4.0 and len(tr) == 2
    assert dict(iter(tr)).keys() == {"x", "z"}


def test_trie_merge_prefers_other():
    a = Trie()
    a.w_observe("x", 1.0, -1.0)
    a.w_observe("sub/y", 2.0, -2.0)
    b = Trie()
    b.w_observe("sub/z", 3.0, -3.0)
    b.w_observe("x", 5.0, -0.5)
    a.merge(b)
    assert a.read("sub/z") == 3.0 and a.read("x") == 5.0
    assert float(a.weight()) == pytest.approx(-5.5)


def test_trie_schema_collect_and_eq():
    tr = Trie()
    tr.w_observe("a", 1.0, -1.0)
    tr.w_observe("s/b", 2.0, -2.0)
    tr.w_observe("s/c", 3.0, -4.0)
    assert tr.schema() == select("a", "s/b", "s/c")
    assert tr == tr.copy() and tr != Trie()
    kept, collected, w = tr.collect(select("s/b"))
    assert collected.read("s/b") == 2.0 and float(w) == pytest.approx(-2.0)
    assert kept.read("a") == 1.0 and kept.read("s/c") == 3.0
    assert kept.search("s/b") is None
    t2 = Trie()
    t2.w_observe("a", 1.0, -1.0)
    kept2, collected2, w2 = t2.collect(t2.schema())
    assert kept2.is_empty() and collected2.read("a") == 1.0
    assert float(w2) == pytest.approx(-1.0)


def test_trie_inner_value_and_tensor_eq():
    tr = Trie()
    tr.observe("sub/x", 1.0)
    node = tr.search("sub")
    assert node.replace_inner((4.0, 5.0)) is None
    assert tr.search("sub").inner() == (4.0, 5.0) and not node.is_leaf()
    assert node.take_inner() == (4.0, 5.0) and node.inner() is None
    a = Trie.from_dict({"v": torch.arange(3.0)})
    assert a == Trie.from_dict({"v": torch.arange(3.0)})
    assert a != Trie.from_dict({"v": torch.arange(1.0, 4.0)})


def test_split_and_selection():
    assert split_addr("test") == ("test",)
    assert split_addr("1/2") == ("1", "2")
    hard = " 1/ 21f23/432 / 132  /   (  y?A1 , grexxy )   "
    assert normalize_addr(hard) == "1 / 21f23 / 432 / 132 / (  y?A1 , grexxy )"
    s = Selection()
    s.visit("a/b/c")
    s.visit("a/d")
    s.visit("e")
    assert s.search("a / b / c").is_leaf() and not s.search("a/b").is_leaf()
    assert s.search("zzz") is None and "a/d" in s and "a/x" not in s
    assert s.leaf_addresses() == ["a / b / c", "a / d", "e"]
    visitor = select("x", "y/a", "y/b")
    assert visitor.all_visited(select("x", "y/a"))
    assert not select("x", "y/a").all_visited(visitor)
    assert select("y").all_visited(select("y/a", "y/b"))
    s = select("a", "b/c", "b/d", "e/f")
    comp = s.complement(select("a", "b/c"))
    assert "b" in comp and comp.search("b/d") is not None
    assert comp.search("b/c") is None and "a" not in comp
    assert comp.search("e").is_leaf() and s.complement(s).is_leaf()
    assert select("a/b", "c") == select("c", "a / b")
    assert select("a") != select("a/b")
    assert hash(select("a/b", "c")) == hash(select("c", "a/b"))
    assert select().is_leaf()


# --- the new scalar distributions ------------------------------------------

def _dist_cases(rng):
    k = rng.integers(-1, 12, 64)
    return [
        (uniform_discrete, j_uniform_discrete, k, (2, 9)),
        (geometric, j_geometric, k, (rng.uniform(0.05, 0.95, 64),)),
        (poisson, j_poisson, k, (rng.uniform(0.1, 9.0, 64),)),
        (gamma, j_gamma, rng.uniform(0.05, 6.0, 64),
         (rng.uniform(0.3, 5.0, 64), rng.uniform(0.2, 3.0, 64))),
        (beta, j_beta, rng.uniform(0.01, 0.99, 64),
         (rng.uniform(0.3, 7.5, 64), rng.uniform(0.3, 7.5, 64))),
    ]


def test_new_scalar_logpdfs_match_reference():
    for port, ref, x, params in _dist_cases(np.random.default_rng(0)):
        want = np.asarray(jax.vmap(lambda xi, *p: ref.logpdf(xi, p))(
            jnp.asarray(x), *(jnp.broadcast_to(jnp.asarray(p), x.shape)
                              for p in params)))
        got = port.logpdf(tensor(x), tuple(
            tensor(p) if isinstance(p, np.ndarray) else p for p in params))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12,
                                   err_msg=repr(port))
    # a scalar call, as the regression test makes it
    assert float(poisson.logpdf(1, 5.0)) == pytest.approx(
        float(j_poisson.logpdf(1, 5.0)), abs=1e-12)
    assert np.isneginf(float(uniform_discrete.logpdf(t(10), (2, 9))))
    assert np.isneginf(float(geometric.logpdf(t(-1), (t(0.5),))))


def test_new_scalar_samplers():
    """Draws from explicit generators: reproducible, of the stated dtype,
    with the distribution's mean."""
    n = 200_000
    cases = [(uniform_discrete, (2, 9), 5.5, torch.int64),
             (geometric, (0.25,), 3.0, torch.int64),
             (poisson, (4.0,), 4.0, torch.int64),
             (gamma, (2.0, 1.5), 3.0, torch.float64),
             (beta, (2.0, 5.0), 2.0 / 7.0, torch.float64)]
    for dist, params, mean, dtype in cases:
        x = dist.sample_batch(generator(7, CPU), (n,), params)
        again = dist.sample_batch(generator(7, CPU), (n,), params)
        assert x.dtype == dtype and x.shape == (n,) and torch.equal(x, again)
        assert float(x.double().mean()) == pytest.approx(mean, rel=0.02)
        assert bool(torch.isfinite(dist.logpdf(x, params)).all())


# --- the MCMC kernels on a batched trace ------------------------------------

A, Q, R = 0.9, 0.5, 0.3


@gen
def lg_step(h, t_, prev):
    x = h.sample(normal, (A * prev, Q), "x")
    h.sample(normal, (x, R), "y")
    return x


@gen
def rw_proposal(h, tr):
    h.sample(normal, (tr.data["x"], 0.6), "x")


def _posterior(prev, y):
    prec = 1 / Q ** 2 + 1 / R ** 2
    return (A * prev / Q ** 2 + y / R ** 2) / prec, 1 / prec


def _batched_trace(n, y=0.3):
    prev = torch.linspace(-0.3, 0.3, n)
    cons = Trie.from_dict({"y": t(y).expand(n)})
    tr, _ = AutoBatchedStep(lg_step).generate(3, (1, prev), cons)
    return tr, prev, y


@pytest.mark.parametrize("which", ["regen", "mh"])
def test_mcmc_kernels_on_a_batched_trace(which):
    """regen_mh_kernel (through the batched regenerate) and mh_kernel
    (through Gen.update on the batched trace): per-particle accepts, the
    exact posterior's moments after a chain, and after every move a logjp
    that a fresh generate of the trace's own choices reproduces."""
    n = 4096
    tr, prev, y = _batched_trace(n)
    kernel = (regen_mh_kernel(AutoBatchedStep(lg_step), select("x"))
              if which == "regen" else mh_kernel(lg_step, rw_proposal))
    final, xs, accepts = mcmc_chain(5, kernel, tr, 40,
                                    extract=lambda tr_: tr_.data["x"])
    assert xs.shape == (40, n) and accepts.shape == (40, n)
    rate = float(accepts.double().mean())
    assert 0.05 < rate < 0.95
    fresh, _ = lg_step.generate(0, final.args, final.data)
    np.testing.assert_allclose(final.logjp.numpy(), fresh.logjp.numpy(),
                               rtol=1e-12)
    mean, var = _posterior(prev, y)
    resid = (final.data["x"] - mean) / math.sqrt(var)
    assert abs(float(resid.mean())) < 0.1
    assert float(resid.var()) == pytest.approx(1.0, abs=0.15)


def test_tree_select_is_elementwise():
    n = 6
    a, _, _ = _batched_trace(n, y=0.1)
    b, _, _ = _batched_trace(n, y=0.9)
    pred = torch.tensor([True, False] * 3)
    out = tree_select(pred, a, b)
    for addr in ("x", "y"):
        want = torch.where(pred, a.data[addr], b.data[addr])
        assert torch.equal(out.data[addr], want)
        assert torch.equal(out.data.search(addr).logp, torch.where(
            pred, a.data.search(addr).logp, b.data.search(addr).logp))
    assert torch.equal(out.logjp, torch.where(pred, a.logjp, b.logjp))
    assert out.data.search("x").dist is normal
