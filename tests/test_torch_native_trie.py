"""The port's C trie core (modppl_tpu_torch/native/ctrie.c) against the
pure-Python one, ``PureTrie``: exact behavioural parity, method by method,
with the port's own rules (elementwise ``weight`` that keeps a particle
axis, plain ``Trie`` children under a Map's ``PlateTrie``, ``copy`` keeping
the class). Counterpart of tests/test_native_trie.py; the whole GFI suite
runs on the native core besides, since ``Trie`` subclasses it."""

import time

import pytest
import torch

from modppl_tpu_torch.core.address import select
from modppl_tpu_torch.core.trie import PureTrie, Trie
from modppl_tpu_torch.native import HAVE_NATIVE_TRIE
from modppl_tpu_torch.modeling.map_combinator import PlateTrie
from _torch_threads import one_thread  # noqa: F401

CLASSES = [Trie, PureTrie]


def test_native_extension_is_active():
    assert HAVE_NATIVE_TRIE, "the C trie core should build at first import"
    from modppl_tpu_torch.native import ctrie

    assert Trie.__mro__[2] is ctrie.CTrieBase
    assert PureTrie.__mro__[2].__name__ == "_PyTrieBase"


@pytest.mark.parametrize("cls", CLASSES)
def test_basic_walk_and_mutation(cls):
    t = cls()
    assert t.is_empty() and not t.is_leaf() and len(t) == 0
    t.w_observe("a / b", 1.5, -0.5)
    t.observe("c", 2.0)
    assert t.read("a / b") == 1.5
    assert t["c"] == 2.0
    assert "a / b" in t and "a/b" in t and "nope" not in t
    assert t.search("a").search("b").is_leaf()
    assert type(t.search("a")) is cls and type(t.search("a / b")) is cls
    assert float(t.weight()) == pytest.approx(-0.5)
    with pytest.raises(KeyError, match='occupied address "c"'):
        t.observe("c", 3.0)
    with pytest.raises(KeyError, match="occupied"):
        t.insert("a / b", cls())
    with pytest.raises(KeyError, match='empty address "zz"'):
        t.read("zz")
    with pytest.raises(KeyError, match='no value found at address "a"'):
        t.read("a")
    sub = t.remove("a / b")
    assert sub.inner() == 1.5
    assert t.search("a") is None
    assert t.remove("a / b") is None


@pytest.mark.parametrize("cls", CLASSES)
def test_inner_value_ops(cls):
    t = cls()
    assert t.inner() is None and t.take_inner() is None
    assert t.replace_inner(7) is None
    assert t.replace_inner(8) == 7
    assert t.has_inner() and t.inner() == 8
    assert t.take_inner() == 8 and not t.has_inner()
    with pytest.raises(KeyError):
        t.expect_inner("boom")


@pytest.mark.parametrize("cls", CLASSES)
def test_weight_is_elementwise(cls):
    """The port's weight keeps a particle axis (the reference's sums each
    leaf); addition order is the node's, then its children's."""
    t = cls()
    t.w_observe("x", torch.ones(3), torch.tensor([-1.0, -2.0, -3.0]))
    t.w_observe("s / y", 0.0, -0.5)
    w = t.weight()
    assert torch.equal(w, torch.tensor([-1.5, -2.5, -3.5]))
    assert t.weight().dtype == torch.float32


def test_native_and_pure_weights_bitwise():
    g = torch.Generator().manual_seed(0)
    leaves = {f"g{i % 4} / x{i}": torch.randn(64, generator=g,
                                              dtype=torch.float64)
              for i in range(40)}
    tries = []
    for cls in CLASSES:
        t = cls()
        for a, lp in leaves.items():
            t.w_observe(a, lp, lp)
        tries.append(t)
    assert torch.equal(tries[0].weight(), tries[1].weight())


@pytest.mark.parametrize("cls", CLASSES)
def test_merge_schema_collect_roundtrip(cls):
    t = cls()
    t.w_observe("a", 1.0, -1.0)
    t.w_observe("s / x", 2.0, -2.0)
    t.w_observe("s / y", 3.0, -3.0)
    other = cls()
    other.w_observe("b", 4.0, -4.0)
    other.w_observe("a", 5.0, -5.0)
    t.merge(other)
    assert t.addresses() == ["a", "b", "s / x", "s / y"]
    assert t.read("a") == 5.0
    kept, collected, w = t.collect(select("s / x"))
    assert float(w) == pytest.approx(-2.0)
    assert collected.read("s / x") == 2.0 and type(collected) is cls
    assert kept.addresses() == ["a", "b", "s / y"]
    assert cls.from_dict({"p": {"q": 1.0}}).read("p / q") == 1.0
    assert cls.from_dict({"p": 1.0}) == cls.from_dict({"p": 1.0})


@pytest.mark.parametrize("cls", CLASSES)
def test_inserting_a_non_trie_raises(cls):
    """``insert`` takes trie nodes only, on either core: a value there
    would be read as a node by the next walk through it. The C core takes
    its own nodes only (a ``PlateTrie`` is one); the pure core either."""
    t = cls()
    with pytest.raises(TypeError, match="must be a trie node"):
        t.insert("a", 5)
    with pytest.raises(TypeError, match="must be a trie node"):
        t.insert("a / b", {"c": 1.0})
    assert t.is_empty()
    t.insert("p", Trie.from_dict({"x": 1.0}))
    t.insert("plate", PlateTrie())
    assert t.read("p / x") == 1.0
    if cls is Trie:
        with pytest.raises(TypeError, match="not a PureTrie"):
            t.insert("q", PureTrie.from_dict({"x": 2.0}))
    else:
        t.insert("q", PureTrie.from_dict({"x": 2.0}))
        assert t.read("q / x") == 2.0


@pytest.mark.parametrize("op", ["read", "search", "w_observe", "insert",
                                "remove"])
def test_native_walk_checks_each_child(op):
    """A non-node set into ``children`` by hand stops every walk of the C
    core with TypeError, never a read of it as a node."""
    t = Trie()
    t.children = {"a": 5}
    call = {"read": lambda: t.read("a / b"),
            "search": lambda: t.search("a / b"),
            "w_observe": lambda: t.w_observe("a / b", 1.0, 0.0),
            "insert": lambda: t.insert("a / b", Trie()),
            "remove": lambda: t.remove("a / b")}[op]
    with pytest.raises(TypeError, match="not a trie node"):
        call()
    assert t.children == {"a": 5}


def test_plate_trie_through_copy_and_weight():
    """A Map's PlateTrie: ``copy`` keeps its class, its new children are
    plain Tries, and its weight sums its plate axis, also as a child whose
    parent's weight runs in C."""
    p = PlateTrie()
    p.w_observe("v", torch.zeros(2, 3), torch.tensor([[1.0, 2.0, 3.0],
                                                      [4.0, 5.0, 6.0]]))
    assert type(p.search("v")) is Trie
    q = p.copy()
    assert type(q) is PlateTrie and type(q.search("v")) is Trie
    assert torch.equal(q.weight(), torch.tensor([6.0, 15.0]))
    for cls in (Trie, PureTrie):
        root = cls()
        root.insert("plate", q)
        root.w_observe("z", 0.0, torch.tensor([0.5, 0.25]))
        assert torch.equal(root.weight(), torch.tensor([6.5, 15.25]))
        assert type(root.copy().search("plate")) is PlateTrie


def test_native_and_pure_agree_on_gfi_flow():
    """The same model generated with constraints in either class gives the
    same trace and weight."""
    from modppl_tpu_torch.dists import normal
    from modppl_tpu_torch.modeling import gen

    @gen
    def m(h):
        a = h.sample(normal, (0.0, 1.0), "a")
        h.sample(normal, (a, 1.0), "obs / y")
        return a

    out = []
    for cls in CLASSES:
        cons = cls.from_dict({"obs": {"y": torch.tensor(0.7)}})
        tr, w = m.generate(3, (), cons, device="cpu")
        out.append((tr, w))
    (tn, wn), (tp, wp) = out
    assert float(wn) == float(wp)
    assert float(tn.logjp) == float(tp.logjp)
    assert tn.data.addresses() == tp.data.addresses()


def test_native_speedup_smoke():
    """Native walks should not be slower than pure Python (a smoke, not a
    performance gate; the reference's bound)."""

    def bench(cls, n=2000):
        t0 = time.perf_counter()
        t = cls()
        for i in range(n):
            t.w_observe(f"grp{i % 50} / x{i}", float(i), -0.1)
        for i in range(n):
            t.read(f"grp{i % 50} / x{i}")
        return time.perf_counter() - t0

    bench(Trie, 200), bench(PureTrie, 200)  # warm caches
    native = min(bench(Trie) for _ in range(3))
    pure = min(bench(PureTrie) for _ in range(3))
    if HAVE_NATIVE_TRIE:
        assert native < pure * 1.5
