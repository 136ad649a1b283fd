"""Addresses, selections, choice-map tries, the GFI and PRNG keys."""

from modppl_tpu_torch.core.address import (
    Selection,
    addr_components,
    addr_hash,
    normalize_addr,
    select,
    split_addr,
)
from modppl_tpu_torch.core.gfi import ArgDiff, GenFn, Trace
from modppl_tpu_torch.core.trie import Trie

__all__ = ["ArgDiff", "GenFn", "Selection", "Trace", "Trie",
           "addr_components", "addr_hash", "normalize_addr", "select",
           "split_addr"]
