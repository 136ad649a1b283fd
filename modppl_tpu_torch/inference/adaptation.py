"""Fixed-order reductions and the warmup schedule (counterpart of
modppl_tpu/inference/adaptation.py:40-61, 130-158)."""

import torch


def warmup_schedule(num_warmup, init_buffer=None, term_buffer=None,
                    base_window=25):
    """Return (fast1, [slow window sizes], fast2) summing to num_warmup:
    Stan's windowed schedule (step size only, doubling mass windows, step
    size only)."""
    if num_warmup < 20:
        return num_warmup, [], 0
    fast1 = init_buffer if init_buffer is not None \
        else max(num_warmup * 15 // 100, 10)
    fast2 = term_buffer if term_buffer is not None \
        else max(num_warmup * 10 // 100, 10)
    slow_total = num_warmup - fast1 - fast2
    if slow_total <= 0:
        return num_warmup, [], 0
    windows = []
    w = base_window
    remaining = slow_total
    while remaining > 0:
        if remaining < 2 * w or remaining < base_window:
            windows.append(remaining)
            remaining = 0
        else:
            windows.append(w)
            remaining -= w
            w *= 2
    return fast1, windows, fast2


def slow_windows(num_warmup):
    """The slow (mass-adapting) windows of ``warmup_schedule`` as
    ``(start, end)`` iteration ranges. A window's metric update and
    dual-averaging restart fire just before iteration ``end``, as in the
    reference's chunk kernels."""
    fast1, slow, _ = warmup_schedule(num_warmup)
    out, start = [], fast1
    for w in slow:
        out.append((start, start + w))
        start += w
    return out


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
