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
many lanes there are. ``rejection_lanes`` runs a rejection sampler over
lanes under the same rule. Each call of a public lane function runs in one
``modppl.lane_words`` span (utils/profiling.annotate): the words' integer
ops and their conversion to uniforms.
"""

import math

import torch

from modppl_tpu_torch.utils.profiling import annotate, host_to_device

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
    return host_to_device(_signed(x), torch.int64, device)


# Each public lane function runs in one span; one calls another only through
# the private bodies below, so a call opens one span however it is built.
_LANE_WORDS = "modppl.lane_words"


def _fold_in_lanes(key_or_lanes, data):
    if not torch.is_tensor(data):
        mixed = _signed(_mix(data & _MASK))
        return _mix_lanes(_as_lanes(key_or_lanes) ^ mixed)
    data = data.to(torch.int64)
    keys = _as_lanes(key_or_lanes, data.device)
    return _mix_lanes(keys ^ _mix_lanes(data))


def fold_in_lanes(key_or_lanes, data):
    """``fold_in`` lane by lane: ``key_or_lanes`` is a host key or a tensor
    of lane keys, ``data`` an int or a tensor; they broadcast. Lane i is
    ``fold_in(key_i, data_i)``."""
    with annotate(_LANE_WORDS):
        return _fold_in_lanes(key_or_lanes, data)


def key_lane(key, device):
    """The host key ``key`` as one lane key, a (1,) int64 tensor: a run over
    it draws what a run keyed by ``key`` on the host would split from it."""
    return _as_lanes(key, device).reshape(1)


def _indices(c, device, offset):
    return torch.arange(offset, offset + c, dtype=torch.int64, device=device)


def lanes(key, c, device, offset=0):
    """(c,) lane keys, lane i ``fold_in(key, offset + i)``: a chain's key
    keyed by its global index, as the reference's ``fold_in(k, i)``. A
    shard holding the indices ``[offset, offset + c)`` builds its own
    lanes without the others'."""
    with annotate(_LANE_WORDS):
        return _fold_in_lanes(key, _indices(c, device, offset))


def split_keys(key, c, device, offset=0):
    """(c,) lane keys, lane i ``split(key, C)[offset + i]`` for any C >
    offset + i, as the reference's ``split(k, C)`` keys one particle or
    chain each; ``offset`` as in :func:`lanes`."""
    with annotate(_LANE_WORDS):
        return _fold_in_lanes(key, _indices(c, device, offset) + (1 << 32))


def split_lanes(key_lanes, num=2):
    """(..., num) keys: ``[..., j]`` is ``split(key_lanes[...], num)[j]``."""
    with annotate(_LANE_WORDS):
        mixed = host_to_device(
            [_signed(_mix((1 << 32) + j)) for j in range(num)], torch.int64,
            key_lanes.device)
        return _mix_lanes(key_lanes[..., None] ^ mixed)


def _lane_bits(key_lanes, k):
    j = torch.arange(k, dtype=torch.int64, device=key_lanes.device)
    return _mix_lanes(_fold_in_lanes(key_lanes[..., None], j))


def lane_bits(key_lanes, k):
    """(..., k) int64 random words: word j of a lane keyed ``key`` is
    ``_mix(fold_in(key, j))``, one pass of tensor ops for every lane."""
    with annotate(_LANE_WORDS):
        return _lane_bits(key_lanes, k)


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
    with annotate(_LANE_WORDS):
        u = _bits_to_uniform(_lane_bits(key_lanes, n), dtype)
    return u.reshape(tuple(key_lanes.shape) + shape)


def normal_lanes(key_lanes, shape=(), dtype=torch.float32):
    """Standard normals, ``torch.special.ndtri`` of ``uniform_lanes``'
    values (one uniform a normal, so a lane's values depend only on its
    key and ``shape``). The uniforms are bitwise equal on every device; the
    normals differ by the devices' ``ndtri`` rounding."""
    return torch.special.ndtri(uniform_lanes(key_lanes, shape, dtype))


# --------------------------------------------------------------------------
# Rejection over lanes
# --------------------------------------------------------------------------
#
# A rejection sampler's lane draw keeps the lane streams' rule: it depends
# only on the lane's key and its shape, never on the number of lanes, nor on
# how many rounds other lanes needed. Round r of element j (of the m a lane
# draws) reads the words at offsets (r m + j) w ... (r m + j) w + w - 1 of
# its lane's counter stream, the words ``lane_bits`` would give there, and
# a lane's element keeps the candidate of the first round that accepts it.

#: rounds every element runs before the first host read
UNROLLED_ROUNDS = 3
#: a draw with an element not accepted after this many rounds raises
#: (at an acceptance of 0.5 a round, the least of the samplers here, that
#: is a chance of 2^-64 an element)
MAX_ROUNDS = 64

_RECORDS = []


class RejectionRecord:
    """What the rejection draws and searches made inside ``record_rejection``
    cost: their elements, the most and the sum of the rounds an element
    took, and the host reads."""

    __slots__ = ("draws", "elements", "max_rounds", "total_rounds", "reads")

    def __init__(self):
        self.draws = self.elements = self.max_rounds = 0
        self.total_rounds = self.reads = 0

    def add(self, rounds, reads):
        self.draws += 1
        self.elements += rounds.numel()
        if rounds.numel():
            self.max_rounds = max(self.max_rounds, int(rounds.max()))
            self.total_rounds += int(rounds.sum())
        self.reads += reads

    @property
    def mean_rounds(self):
        return self.total_rounds / max(self.elements, 1)


class record_rejection:
    """``with record_rejection() as rec:`` counts the rounds and host reads
    of every rejection draw in the block (each count is itself a host
    read, so only a measurement records)."""

    def __enter__(self):
        self.record = RejectionRecord()
        _RECORDS.append(self.record)
        return self.record

    def __exit__(self, *exc):
        _RECORDS.remove(self.record)


def note_rounds(rounds, reads):
    """Add a draw's per-element rounds (a tensor, or a function giving it)
    and its host ``reads`` to every open ``record_rejection``."""
    if _RECORDS and callable(rounds):
        rounds = rounds()
    for rec in _RECORDS:
        rec.add(rounds, reads)


def words_at(key_lanes, offsets):
    """The words at ``offsets`` of the lanes' counter streams (broadcast):
    word j of a lane keyed ``key`` is ``lane_bits``' word j."""
    with annotate(_LANE_WORDS):
        return _mix_lanes(_fold_in_lanes(key_lanes, offsets))


def rejection_lanes(key_lanes, m, words, propose, params=(),
                    unrolled=UNROLLED_ROUNDS, max_rounds=MAX_ROUNDS):
    """(C, m) draws by rejection, m a lane of the (C,) ``key_lanes``.

    ``propose(bits, *params)`` maps (..., ``words``) int64 words and the
    parameters (each a tensor of the words' leading shape, or a number) to
    (candidate, accepted), elementwise; ``params`` are (C, m) tensors or
    numbers. The first ``unrolled`` rounds run on every element with no
    host read; after them each round reads once which elements are still
    open and runs on those alone. Past ``max_rounds`` rounds an open
    element raises ``RuntimeError``."""
    c = key_lanes.shape[0]
    dev = key_lanes.device
    t = torch.arange(words, dtype=torch.int64, device=dev)
    j = torch.arange(m, dtype=torch.int64, device=dev)
    unrolled = max(1, min(unrolled, max_rounds))
    for r in range(unrolled):
        cand, acc = propose(words_at(key_lanes[:, None, None],
                                     (r * m + j)[:, None] * words + t),
                            *params)
        if r == 0:
            out, done, rounds = cand, acc, acc.to(torch.int32)
        else:
            take = acc & ~done
            out = torch.where(take, cand, out)
            rounds = torch.where(take, r + 1, rounds)
            done = done | acc
    out, rounds, done = (x.reshape(-1).clone()
                         for x in (out, rounds, done))
    flat = [p.reshape(-1) if torch.is_tensor(p) else p for p in params]
    reads = 0
    r = unrolled
    while True:
        open_ = torch.nonzero(~done).reshape(-1)  # the round's host read
        reads += 1
        if open_.numel() == 0:
            break
        if r >= max_rounds:
            raise RuntimeError(
                f"rejection draw: {open_.numel()} of {c * m} elements not "
                f"accepted in {max_rounds} rounds")
        el = open_ % m
        cand, acc = propose(
            words_at(key_lanes[open_ // m][:, None],
                     (r * m + el)[:, None] * words + t),
            *(p[open_] if torch.is_tensor(p) else p for p in flat))
        hit = open_[acc]
        out[hit] = cand[acc]
        rounds[hit] = r + 1
        done[hit] = True
        r += 1
    note_rounds(rounds, reads)
    return out.reshape(c, m)
