"""The random streams a run is keyed by, worked out from the seed alone.

A key is a 64-bit integer mixed by SplitMix64's finaliser. ``fold_in(k, d)``
mixes an integer into a key, ``split(k, n)`` is ``fold_in(k, 2^32 + j)``
for j < n, and a key seeds a ``torch.Generator`` on the device the draw is
made on. A lane stream (one chain or particle a key) takes word j of lane
key k as ``mix(fold_in(k, j))``; its uniforms are the word's top 24 bits
over 2^24 (0 moved to 2^-25) and its normals their inverse normal CDF. A
sample site's key is ``fold_in(key, fnv1a31(address))``.

This is the keying the program under test documents for its streams; the
reference derives every draw from the seed by these rules, in plain
integer arithmetic, so it needs nothing the program computed.
"""

import numpy as np
import torch

MASK = (1 << 64) - 1


def mix(z):
    """SplitMix64's finaliser of ``z + golden``, on a Python int."""
    z = (z + 0x9E3779B97F4A7C15) & MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK
    return z ^ (z >> 31)


def fold_in(key, data):
    return mix(key ^ mix(data & MASK))


def split(key, num=2):
    return tuple(fold_in(key, (1 << 32) + j) for j in range(num))


def generator(key, device):
    g = torch.Generator(device=device)
    g.manual_seed(key & MASK)
    return g


def fnv1a31(address):
    """31-bit FNV-1a of the address's UTF-8 bytes."""
    h = 2166136261
    for byte in address.encode():
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


# --------------------------------------------------------------------------
# lane streams, in numpy uint64 (arithmetic wraps modulo 2^64)
# --------------------------------------------------------------------------

def _mix_u64(z):
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def lane_keys(key, num):
    """(num,) lane keys, lane i ``fold_in(key, i)``: a particle's key by
    its index."""
    return _mix_u64(np.uint64(key) ^ _mix_u64(np.arange(num, dtype=np.uint64)))


def split_lane_keys(key, num):
    """(num,) lane keys, lane i ``split(key, C)[i]`` for any C > i."""
    i = np.arange(num, dtype=np.uint64) + np.uint64(1 << 32)
    return _mix_u64(np.uint64(key) ^ _mix_u64(i))


def lane_uniforms(lane_keys, count):
    """(C, count) uniforms in (0, 1) of float32 resolution, as float64."""
    j = np.arange(count, dtype=np.uint64)
    words = _mix_u64(_mix_u64(lane_keys[:, None] ^ _mix_u64(j)[None, :]))
    u = (words >> np.uint64(40)).astype(np.float64) * 2.0 ** -24
    return np.maximum(u, 2.0 ** -25)


def lane_normals(lane_keys, count, device):
    """(C, count) standard normals (float64) on ``device``."""
    u = torch.from_numpy(lane_uniforms(lane_keys, count)).to(device)
    return torch.special.ndtri(u)
