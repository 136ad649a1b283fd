"""Weighted tries as choice maps (counterpart of modppl_tpu/core/trie.py).

A pure-Python trie whose values and per-leaf log-probabilities are tensors
(or Python numbers). Same structural semantics as the reference: writes to
an occupied address raise, ``remove`` prunes empty intermediate nodes.

Each leaf also records the distribution that drew it (``dist``), which
gradient inference reads to pick an unconstraining bijector. ``merge``
prefers the other trie's values, ``collect(mask)`` splits a trie into
(kept, collected, collected weight) and ``schema()`` gives its address
structure as a Selection.

One difference follows from the port's batched tier, where a model body runs
once on tensors whose leading axis is the particle axis: ``weight`` adds the
leaf log-probabilities elementwise and keeps that axis, so a batched trace
has one log-joint per particle.
"""

import torch

from modppl_tpu_torch.core.address import Selection, addr_components

_EMPTY = object()  # sentinel: "no inner value" (distinct from a stored None)


def _values_equal(a, b):
    if torch.is_tensor(a) or torch.is_tensor(b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return a.shape == b.shape and bool(torch.all(a == b.to(a.device)))
    return a == b


class Trie:
    """Hierarchical choice map: children dict + optional inner value + leaf logp."""

    __slots__ = ("children", "value", "logp", "dist")

    def __init__(self):
        self.children = {}
        self.value = _EMPTY
        self.logp = 0.0
        self.dist = None  # Distribution that drew this leaf, if any

    @classmethod
    def leaf(cls, value, logp=0.0, dist=None):
        """A leaf node holding ``value`` with weight ``logp``."""
        t = cls()
        t.value = value
        t.logp = logp
        t.dist = dist
        return t

    # ---- structure --------------------------------------------------------

    def is_empty(self):
        """No inner value and no descendants."""
        return not self.children and self.value is _EMPTY

    def is_leaf(self):
        """Inner value but no descendants."""
        return not self.children and self.value is not _EMPTY

    def has_inner(self):
        return self.value is not _EMPTY

    def inner(self):
        """Inner value or None."""
        return None if self.value is _EMPTY else self.value

    def take_inner(self):
        """Remove and return the inner value, or None."""
        v = self.inner()
        self.value = _EMPTY
        return v

    def replace_inner(self, value):
        """Set the inner value, returning the previous one or None. The
        leaf weight is untouched: a sub-call's return value carries none."""
        prev = self.inner()
        self.value = value
        return prev

    def expect_inner(self, msg):
        if self.value is _EMPTY:
            raise KeyError(msg)
        return self.value

    def weight(self):
        """Sum of the leaf log-probabilities below (and at) this node,
        elementwise over any particle axis."""
        acc = self.logp
        for sub in self.children.values():
            acc = acc + sub.weight()
        return acc

    # ---- search / read ----------------------------------------------------

    def search(self, addr):
        """Descendant node at ``addr``, or None."""
        node = self
        for c in addr_components(addr):
            node = node.children.get(c)
            if node is None:
                return None
        return node

    def read(self, addr):
        """Inner value at ``addr``; raises on a missing address."""
        node = self.search(addr)
        if node is None:
            raise KeyError(f'read: failed when searching empty address "{addr}"')
        return node.expect_inner(f'read: no value found at address "{addr}"')

    def __contains__(self, addr):
        return self.search(addr) is not None

    def __getitem__(self, addr):
        return self.read(addr)

    def __iter__(self):
        """(component, sub-trie) over the direct descendants."""
        return iter(self.children.items())

    def __len__(self):
        return len(self.children)

    # ---- writes -----------------------------------------------------------

    def _parent_of(self, addr):
        comps = addr_components(addr)
        node = self
        for c in comps[:-1]:
            node = node.children.setdefault(c, Trie())
        return node, comps[-1]

    def w_observe(self, addr, value, logp, dist=None):
        """Store a weighted ``value`` leaf at ``addr``; raises if occupied.
        ``dist`` records the distribution that drew ``value``."""
        node, last = self._parent_of(addr)
        if last in node.children:
            raise KeyError(
                f'w_observe: attempted to put into occupied address "{last}"')
        leaf = Trie()
        leaf.value = value
        leaf.logp = logp
        leaf.dist = dist
        node.children[last] = leaf

    def observe(self, addr, value):
        """Store an unweighted ``value`` leaf at ``addr``; raises if occupied."""
        self.w_observe(addr, value, 0.0)

    def __setitem__(self, addr, value):
        self.observe(addr, value)

    def insert(self, addr, sub):
        """Insert sub-trie at ``addr``; raises if occupied."""
        node, last = self._parent_of(addr)
        if last in node.children:
            raise KeyError(
                f'insert: attempted to put into occupied address "{last}"')
        node.children[last] = sub

    def remove(self, addr):
        """Remove and return the sub-trie at ``addr``, or None. Empty
        intermediate nodes are pruned."""
        comps = addr_components(addr)
        path = []
        node = self
        for c in comps:
            path.append(node)
            node = node.children.get(c)
            if node is None:
                return None
        del path[-1].children[comps[-1]]
        for i in range(len(comps) - 1, 0, -1):
            if not path[i].is_empty():
                break
            del path[i - 1].children[comps[i - 1]]
        return node

    def merge(self, other):
        """Merge ``other`` into self; on a leaf present in both, other's
        value and weight win."""
        for addr, othersub in list(other.children.items()):
            mine = self.children.get(addr)
            if othersub.is_leaf():
                if mine is not None:
                    del self.children[addr]
                self.w_observe(addr, othersub.value, othersub.logp,
                               othersub.dist)
            elif mine is not None:
                mine.merge(othersub)
            else:
                self.insert(addr, othersub)

    # ---- schema / collect -------------------------------------------------

    def schema(self):
        """The Selection of the trie's address structure."""
        sel = Selection()
        for addr, sub in self.children.items():
            if sub.is_leaf():
                sel.visit(addr)
            else:
                sel.insert(addr, sub.schema())
        return sel

    def collect(self, mask):
        """Split self by the Selection ``mask``: returns (kept, collected,
        collected weight), ``collected`` holding the values under ``mask``
        and ``kept`` the rest. Consumes self: both results may share its
        nodes."""
        collected = Trie()
        if self.schema() == mask:
            return Trie(), self, self.weight()
        if not mask.is_leaf():
            for addr, submask in mask:
                sub = self.remove(addr)
                if sub is None:
                    raise KeyError(
                        f'collect: mask address "{addr}" not in trie')
                if submask.is_leaf():
                    collected.insert(addr, sub)
                else:
                    sub, subcollected, _ = sub.collect(submask)
                    if not sub.is_empty():
                        self.insert(addr, sub)
                    if not subcollected.is_empty():
                        collected.insert(addr, subcollected)
        return self, collected, collected.weight()

    # ---- conversion -------------------------------------------------------

    def copy(self):
        """Structural copy of the same class (a Map's ``PlateTrie`` stays
        one); values are shared, not cloned."""
        t = type(self)()
        t.value = self.value
        t.logp = self.logp
        t.dist = self.dist
        t.children = {k: v.copy() for k, v in self.children.items()}
        return t

    def map(self, fn):
        """A structural copy with ``fn`` applied to every inner value (e.g.
        slicing step ``t`` out of stacked per-step constraints)."""
        t = self.copy()
        for node in t._nodes():
            if node.value is not _EMPTY:
                node.value = fn(node.value)
        return t

    def values(self):
        """Every inner value in the trie, depth first."""
        return [node.value for node in self._nodes()
                if node.value is not _EMPTY]

    def _nodes(self):
        yield self
        for sub in self.children.values():
            yield from sub._nodes()

    @classmethod
    def from_dict(cls, d):
        """An unweighted Trie from a nested dict of {component: value|dict}."""
        t = cls()
        for k, v in d.items():
            if isinstance(v, dict):
                t.insert(k, cls.from_dict(v))
            else:
                t.observe(k, v)
        return t

    def as_dict(self):
        """Nested plain-dict view {component: value|dict}."""
        out = {}
        if self.value is not _EMPTY:
            out["__value__"] = self.value
        for k, v in self.children.items():
            out[k] = v.inner() if v.is_leaf() else v.as_dict()
        return out

    def addresses(self, prefix=""):
        """All leaf-value addresses, ' / '-joined, sorted."""
        out = []
        for k in sorted(self.children):
            sub = self.children[k]
            path = k if not prefix else f"{prefix} / {k}"
            if sub.has_inner():
                out.append(path)
            if sub.children:
                out.extend(sub.addresses(path))
        return out

    def __eq__(self, other):
        if not isinstance(other, Trie):
            return NotImplemented
        if set(self.children) != set(other.children):
            return False
        if (self.value is _EMPTY) != (other.value is _EMPTY):
            return False
        if self.value is not _EMPTY and not _values_equal(self.value,
                                                          other.value):
            return False
        if not _values_equal(self.logp, other.logp):
            return False
        return all(self.children[k] == other.children[k]
                   for k in self.children)

    __hash__ = None

    def __repr__(self):
        if self.is_leaf():
            return f"Trie.leaf({self.value!r}, logp={self.logp!r})"
        return f"Trie({self.as_dict()!r})"
