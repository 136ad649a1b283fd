"""Counter-style PRNG keys as plain integers (the port's ``jax.random`` keys).

A key is a 64-bit Python int. ``split`` and ``fold_in`` derive new keys on
the host with SplitMix64 mixing, so deriving a key never touches the device.
``generator`` turns a key into a ``torch.Generator`` on a given device; the
samplers draw from that generator. The numbers differ from JAX's threefry
streams: tests that compare the two sides hand both the same draws.
"""

import torch

_MASK = (1 << 64) - 1


def _mix(z):
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def fold_in(key, data):
    """A new key from ``key`` and an integer ``data``."""
    return _mix(key ^ _mix(data & _MASK))


def split(key, num=2):
    """``num`` independent keys from ``key``."""
    return tuple(fold_in(key, (1 << 32) + i) for i in range(num))


def generator(key, device):
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(key & _MASK)
    return g
