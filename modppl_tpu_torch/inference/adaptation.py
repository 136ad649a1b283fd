"""Fixed-order reductions (counterpart of
modppl_tpu/inference/adaptation.py:130-158)."""

import torch


def _tree_sum(x):
    """Sum over the leading axis by an explicit ADJACENT-pairing add tree:
    (x[0]+x[1]), (x[2]+x[3]), ... per level, odd extents zero-padded to a
    power of two. The same association as the reference, so the result is
    bitwise the reference's on the same input."""
    n = x.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while p > 1:
        p //= 2
        x = x[0::2] + x[1::2]
    return x[0]
