"""Hierarchical string addresses and selections (counterpart of
modppl_tpu/core/address.py).

``split_addr``, ``normalize_addr``, ``addr_components`` and the 31-bit
FNV-1a ``addr_hash``, which must give the JAX package's value for every
address, because per-address random streams are derived from it on both
sides; and ``Selection``, a recursive address set used as a mask
(regenerate) and as a visitor record (the garbage collection of update and
regenerate).
"""

import re
from functools import lru_cache

_ADDR_RE = re.compile(r"^(.*?)/(.*)$")


def split_addr(addr):
    """Split at the first ``/`` into ``(term,)`` or ``(first, rest)``."""
    m = _ADDR_RE.match(addr)
    if m is None:
        return (addr.strip(),)
    return (m.group(1).strip(), m.group(2))


@lru_cache(maxsize=65536)
def normalize_addr(addr):
    """Canonicalize separators to ``" / "``."""
    parts = split_addr(addr)
    if len(parts) == 1:
        return parts[0]
    return f"{parts[0]} / {normalize_addr(parts[1])}"


@lru_cache(maxsize=65536)
def addr_components(addr):
    """The address's components, outermost first."""
    out = []
    while True:
        parts = split_addr(addr)
        out.append(parts[0])
        if len(parts) == 1:
            return tuple(out)
        addr = parts[1]


@lru_cache(maxsize=65536)
def addr_hash(addr):
    """31-bit FNV-1a over the normalized address."""
    h = 2166136261
    for b in normalize_addr(addr).encode():
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


class Selection:
    """A recursive set of addresses, used as a mask and as a visitor
    record. A node with no children is a leaf: as a mask it selects the
    whole subtree below its path."""

    __slots__ = ("children",)

    def __init__(self, addrs=()):
        self.children = {}
        for a in addrs:
            self.visit(a)

    def is_leaf(self):
        return not self.children

    def search(self, addr):
        """Descendant at ``addr``, or None."""
        parts = split_addr(addr)
        sub = self.children.get(parts[0])
        if len(parts) == 1 or sub is None:
            return sub
        return sub.search(parts[1])

    def insert(self, addr, sub):
        """Insert a descendant selection at a single-component ``addr``."""
        self.children[addr] = sub

    def visit(self, addr):
        """Add ``addr`` (all its components) to the selection."""
        parts = split_addr(addr)
        sub = self.children.setdefault(parts[0], Selection())
        if len(parts) == 2:
            sub.visit(parts[1])

    def all_visited(self, other):
        """True if every address of ``other`` (or an ancestor of it) is in
        self."""
        for addr, sub in other.children.items():
            mine = self.search(addr)
            if mine is None:
                return False
            if not mine.is_leaf() and not mine.all_visited(sub):
                return False
        return True

    def complement(self, mask):
        """Addresses of self absent from ``mask``. A leaf of ``mask`` covers
        its whole subtree; a leaf of self under a non-leaf of ``mask``
        contributes nothing, as in the reference."""
        out = Selection()
        for addr, sub in self.children.items():
            sub_mask = mask.search(addr)
            if sub_mask is None:
                out.visit(addr)
            elif not sub.is_leaf() and not sub_mask.is_leaf():
                sub_comp = sub.complement(sub_mask)
                if not sub_comp.is_leaf():
                    out.insert(addr, sub_comp)
        return out

    def leaf_addresses(self, prefix=""):
        """Every maximal address of the selection, joined with ' / '."""
        out = []
        for addr, sub in sorted(self.children.items()):
            path = addr if not prefix else f"{prefix} / {addr}"
            if sub.is_leaf():
                out.append(path)
            else:
                out.extend(sub.leaf_addresses(path))
        return out

    def __iter__(self):
        return iter(self.children.items())

    def __contains__(self, addr):
        return self.search(addr) is not None

    def __eq__(self, other):
        return isinstance(other, Selection) and self.children == other.children

    def __hash__(self):
        return hash(tuple(sorted((k, hash(v))
                                 for k, v in self.children.items())))

    def __repr__(self):
        if self.is_leaf():
            return "Selection(<leaf>)"
        inner = ", ".join(f"{k!r}: {v!r}"
                          for k, v in sorted(self.children.items()))
        return f"Selection({{{inner}}})"


def select(*addrs):
    """``select(*addresses)``: the Selection of those addresses."""
    return Selection(addrs)
