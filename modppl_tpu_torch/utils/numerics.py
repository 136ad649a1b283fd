"""Log-space and prefix-sum helpers (counterpart of
modppl_tpu/utils/numerics.py:13-31, plus the cumulative sum the resampling
schemes share).

``ordered_cumsum`` is a prefix sum in a fixed add order: the order XLA's CPU
backend uses for ``jnp.cumsum`` (its reduce-window rewrite with base 16: a
scan inside rows of 16, the row totals scanned the same way, recursively,
then each row offset by the exclusive prefix of the totals before it). On a
CPU tensor the scan inside a row runs left to right in the tensor's dtype,
so the resampling CDFs equal the reference's bit for bit. On a CUDA tensor,
where no reference runs, the rows are 1024 wide and each level is one
``torch.cumsum`` along the last axis of a tensor of at least two rows
(PyTorch's per-row scan, whose order is fixed). A ``torch.cumsum`` over a
single row on the card is CUB's decoupled look-back scan, whose float sums
depend on the blocks' timing: two runs on the same weights can differ in
the last bit, which moves a systematic ancestor, so it is not used.
"""

import torch

# XLA's ReduceWindowRewriter base length on the CPU backend; the row width
# on the card
_SCAN_BASE = 16
_CUDA_ROW = 1024


def logsumexp(xs, dim=None):
    """log(sum(exp(xs))) with the max shift; -inf when every entry is -inf
    (jax.scipy.special.logsumexp's semantics). ``dim=None`` reduces all."""
    if dim is None:
        return torch.logsumexp(xs.reshape(-1), 0)
    return torch.logsumexp(xs, dim)


def effective_sample_size_from_log_weights(log_normalized_weights):
    """ESS = 1 / sum(w_i^2) in log space: exp(-logsumexp(2 lw))."""
    return torch.exp(-logsumexp(2.0 * log_normalized_weights))


def _row_scan(a):
    """Inclusive scan along the last axis, left to right, starting from 0
    as a reduce-window does (so a leading -0.0 becomes +0.0)."""
    acc = 0 + a[..., 0]
    cols = [acc]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _cuda_rows(a):
    """Per-row scans along the last axis of ``a`` on the card, as rows of
    one (R, W) tensor; a single row gets a zero row beside it so that
    PyTorch takes its per-row kernel."""
    rows = a.reshape(-1, a.shape[-1])
    if rows.shape[0] > 1:
        return torch.cumsum(rows, 1).reshape(a.shape)
    return torch.cumsum(torch.cat([rows, torch.zeros_like(rows)]),
                        1)[:1].reshape(a.shape)


def ordered_cumsum(x):
    """Inclusive prefix sum along the last axis of ``x`` (see the module
    docstring); each row of a batch is summed as the 1-D ``x`` would be."""
    n = x.shape[-1]
    lead = tuple(x.shape[:-1])
    cpu = x.device.type == "cpu"
    base = _SCAN_BASE if cpu else _CUDA_ROW
    if n <= base:
        return _row_scan(x) if cpu else _cuda_rows(x)
    rows = -(-n // base)
    if rows * base != n:
        x = torch.cat([x, x.new_zeros(lead + (rows * base - n,))], dim=-1)
    x = x.reshape(lead + (rows, base))
    inner = _row_scan(x) if cpu else _cuda_rows(x)
    tails = ordered_cumsum(inner[..., -1])
    offsets = torch.cat([tails.new_zeros(lead + (1,)), tails[..., :-1]],
                        dim=-1)
    return (inner + offsets[..., None]).reshape(lead + (-1,))[..., :n]


def normalized_cdf(log_normalized_weights):
    """cumsum(exp(lw)) / its last entry (parallel/resample.py:29-31), along
    the last axis."""
    cdf = ordered_cumsum(torch.exp(log_normalized_weights))
    return cdf / cdf[..., -1:]
