"""Counter-style PRNG keys as plain integers (the port's ``jax.random`` keys).

A key is a 64-bit Python int. ``split`` and ``fold_in`` derive new keys on
the host with SplitMix64 mixing, so deriving a key never touches the device.
``generator`` turns a key into a ``torch.Generator`` on a given device; the
samplers draw from that generator. The numbers differ from JAX's threefry
streams: tests that compare the two sides hand both the same draws.

Lane keys (``fold_in_lanes``, ``lanes``, ``split_keys``, ``split_lanes``)
are the same derivations run on the device for a (C,) tensor of keys, one
per chain or particle, and ``uniform_lanes`` / ``normal_lanes`` draw from
each lane's own counter stream, so a lane's draws do not depend on how
many lanes there are.
"""

import math

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


# --------------------------------------------------------------------------
# Lane keys: one key a chain or particle, as a (C,) int64 tensor
# --------------------------------------------------------------------------
#
# The same SplitMix64 in torch integer ops, on the lanes' device. Torch has
# no usable uint64, so the arithmetic runs in int64: the constants above
# 2^63 are written as their two's-complement values, additions and
# multiplications wrap modulo 2^64 as the unsigned ones do, and every right
# shift is masked to a logical one. Lane i of each function is bitwise the
# host function's value for lane i's key (tests/test_torch_keys_lanes.py).


def _signed(x):
    """A 64-bit pattern as the int64 of the same bits."""
    x &= _MASK
    return x - (1 << 64) if x >> 63 else x


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MUL1 = _signed(0xBF58476D1CE4E5B9)
_MUL2 = _signed(0x94D049BB133111EB)


def _srl(z, s):
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix_lanes(z):
    z = z + _GOLDEN
    z = (z ^ _srl(z, 30)) * _MUL1
    z = (z ^ _srl(z, 27)) * _MUL2
    return z ^ _srl(z, 31)


def _as_lanes(x, device=None):
    """An int or an int64 tensor as an int64 tensor (an int as 0-dim)."""
    if torch.is_tensor(x):
        return x.to(torch.int64)
    return torch.tensor(_signed(x), dtype=torch.int64, device=device)


def fold_in_lanes(key_or_lanes, data):
    """``fold_in`` lane by lane: ``key_or_lanes`` is a host key or a tensor
    of lane keys, ``data`` an int or a tensor; they broadcast. Lane i is
    ``fold_in(key_i, data_i)``."""
    if not torch.is_tensor(data):
        mixed = _signed(_mix(data & _MASK))
        return _mix_lanes(_as_lanes(key_or_lanes) ^ mixed)
    data = data.to(torch.int64)
    keys = _as_lanes(key_or_lanes, data.device)
    return _mix_lanes(keys ^ _mix_lanes(data))


def key_lane(key, device):
    """The host key ``key`` as one lane key, a (1,) int64 tensor: a run over
    it draws what a run keyed by ``key`` on the host would split from it."""
    return _as_lanes(key, device).reshape(1)


def lanes(key, c, device):
    """(c,) lane keys, lane i ``fold_in(key, i)``: a chain's key keyed by
    its index, as the reference's ``fold_in(k, i)``."""
    return fold_in_lanes(key, torch.arange(c, dtype=torch.int64,
                                           device=device))


def split_keys(key, c, device):
    """(c,) lane keys, lane i ``split(key, c)[i]``, as the reference's
    ``split(k, c)`` keys one particle or chain each."""
    return fold_in_lanes(key, torch.arange(c, dtype=torch.int64,
                                           device=device) + (1 << 32))


def split_lanes(key_lanes, num=2):
    """(..., num) keys: ``[..., j]`` is ``split(key_lanes[...], num)[j]``."""
    mixed = torch.tensor([_signed(_mix((1 << 32) + j)) for j in range(num)],
                         dtype=torch.int64, device=key_lanes.device)
    return _mix_lanes(key_lanes[..., None] ^ mixed)


def lane_bits(key_lanes, k):
    """(..., k) int64 random words: word j of a lane keyed ``key`` is
    ``_mix(fold_in(key, j))``, one pass of tensor ops for every lane."""
    j = torch.arange(k, dtype=torch.int64, device=key_lanes.device)
    return _mix_lanes(fold_in_lanes(key_lanes[..., None], j))


def _bits_to_uniform(bits, dtype):
    """Uniforms in (0, 1) from the words' top 24 (float32) or 53 (float64)
    bits: m / 2^b, with m = 0 moved to 2^-(b + 1)."""
    b = 24 if dtype in (torch.float32, torch.float16, torch.bfloat16) else 53
    u = _srl(bits, 64 - b).to(dtype) * (2.0 ** -b)
    return torch.clamp(u, min=2.0 ** -(b + 1))


def uniform_lanes(key_lanes, shape=(), dtype=torch.float32):
    """``key_lanes.shape + shape`` uniforms in (0, 1). A lane's values
    depend only on its key and ``shape`` (element j of the flattened shape
    takes word j of ``lane_bits``), never on the number of lanes."""
    shape = tuple(shape)
    n = math.prod(shape)
    u = _bits_to_uniform(lane_bits(key_lanes, n), dtype)
    return u.reshape(tuple(key_lanes.shape) + shape)


def normal_lanes(key_lanes, shape=(), dtype=torch.float32):
    """Standard normals, ``torch.special.ndtri`` of ``uniform_lanes``'
    values (one uniform a normal, so a lane's values depend only on its
    key and ``shape``). The uniforms are bitwise equal on every device; the
    normals differ by the devices' ``ndtri`` rounding."""
    return torch.special.ndtri(uniform_lanes(key_lanes, shape, dtype))
