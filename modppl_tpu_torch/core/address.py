"""Hierarchical string addresses (counterpart of modppl_tpu/core/address.py).

Only what the particle-filter slice needs: ``normalize_addr``,
``addr_components`` and the 31-bit FNV-1a ``addr_hash``, which must give the
JAX package's value for every address, because per-address random streams
are derived from it on both sides.
"""

import re
from functools import lru_cache

_ADDR_RE = re.compile(r"^(.*?)/(.*)$")


def _split_addr(addr):
    """Split at the first ``/`` into ``(term,)`` or ``(first, rest)``."""
    m = _ADDR_RE.match(addr)
    if m is None:
        return (addr.strip(),)
    return (m.group(1).strip(), m.group(2))


@lru_cache(maxsize=65536)
def normalize_addr(addr):
    """Canonicalize separators to ``" / "``."""
    parts = _split_addr(addr)
    if len(parts) == 1:
        return parts[0]
    return f"{parts[0]} / {normalize_addr(parts[1])}"


@lru_cache(maxsize=65536)
def addr_components(addr):
    """The address's components, outermost first."""
    out = []
    while True:
        parts = _split_addr(addr)
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
