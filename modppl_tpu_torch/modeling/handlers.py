"""The generate handler of the DSL (counterpart of
modppl_tpu/modeling/handlers.py:45-160).

Randomness comes from an explicit integer key (core/keys.py). Each address
derives its own key, ``fold_in(key, addr_hash(addr))``, and draws from a
``torch.Generator`` seeded with it on the handler's device, so sampling is
order-independent and reproducible.
"""

import torch

from modppl_tpu_torch.core.address import addr_hash
from modppl_tpu_torch.core.keys import fold_in, generator


def addr_subkey(key, addr):
    """The per-address key: ``fold_in(key, addr_hash(addr))``."""
    return fold_in(key, addr_hash(addr))


def infer_dtype_device(args, device=None):
    """dtype and device of the first floating tensor in ``args`` (searched
    through tuples and lists); without one, torch's default dtype on the
    first tensor's device (an integer state, such as an HMM's). An explicit
    ``device`` wins over the arguments'. With neither a tensor nor a
    ``device``, raise: a model without tensor arguments must be told where
    to run rather than falling back to the CPU."""
    stack, first = list(args), None
    while stack:
        a = stack.pop(0)
        if torch.is_tensor(a) and a.is_floating_point():
            return a.dtype, torch.device(a.device if device is None
                                         else device)
        if torch.is_tensor(a) and first is None:
            first = a
        if isinstance(a, (tuple, list)):
            stack[:0] = list(a)
    if device is None and first is not None:
        device = first.device
    if device is None:
        raise ValueError(
            "no floating tensor argument to take a device from: pass "
            "device= (e.g. 'cuda' or 'cpu')")
    return torch.get_default_dtype(), torch.device(device)


class GenerateHandler:
    """GFI ``generate`` execution state: constrained sites score and add to
    the weight; unconstrained sites draw fresh values."""

    def __init__(self, key, trace, constraints, dtype, device):
        self.key = key
        self.tr = trace
        self.constraints = constraints
        self.weight = 0.0
        self.dtype = dtype
        self.device = device

    def _draw(self, dist, params, addr):
        """Fresh draw at an unconstrained address. The batched tier
        overrides this (modeling/autobatch.py)."""
        g = generator(addr_subkey(self.key, addr), self.device)
        return dist.sample(g, params, dtype=self.dtype)

    def sample(self, dist, params, addr):
        choice = self.constraints.remove(addr)
        if choice is not None:
            x = choice.expect_inner(f"error: no value found in {addr}")
            logp = dist.logpdf(x, params)
            self.weight = self.weight + logp
        else:
            x = self._draw(dist, params, addr)
            logp = dist.logpdf(x, params)
        self.tr.data.w_observe(addr, x, logp, dist)
        return x
