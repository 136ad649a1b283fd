"""Resampling gathers (counterpart of modppl_tpu/parallel/resample.py:208-251).

``gather_from_s`` is the counterpart of ``fused_gather_from_s_or_none``
without the "or none": it always goes through kernel 3's wrapper, which
launches the kernel on CUDA tensors (or raises on what the kernel does not
take) and runs the plain version on CPU tensors.
"""

import torch
from torch.utils import _pytree as pytree

from modppl_tpu_torch.ops.fused_resample import resample_fused_from_s


def gather_from_s(s, tree):
    """Ancestors from the sorted slot positions ``s`` and every leaf of the
    particle-state pytree ``tree`` (leading axis N) copied from its
    ancestor. Returns ``(new_tree, parents)``.

    The leaves' trailing axes are flattened into the columns of one (N, C)
    block, so a single launch serves the whole state."""
    n = s.shape[0]
    leaves, spec = pytree.tree_flatten(tree)
    cols = [leaf.reshape(n, -1) for leaf in leaves]
    block = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    new_block, parents = resample_fused_from_s(s, block.contiguous(),
                                               layout="nc")
    out, off = [], 0
    for leaf, col in zip(leaves, cols):
        k = col.shape[1]
        out.append(new_block[:, off:off + k].reshape(leaf.shape))
        off += k
    return pytree.tree_unflatten(out, spec), parents
