"""Addresses, choice-map tries, the GFI and PRNG keys."""

from modppl_tpu_torch.core.address import addr_components, addr_hash, normalize_addr
from modppl_tpu_torch.core.gfi import GenFn, Trace
from modppl_tpu_torch.core.trie import Trie

__all__ = ["GenFn", "Trace", "Trie", "addr_components", "addr_hash",
           "normalize_addr"]
