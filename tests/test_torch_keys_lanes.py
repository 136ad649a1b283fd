"""Lane keys and lane draws (core/keys.py, ``Distribution.sample_lanes``,
the lane handlers of modeling/handlers.py), on the CPU.

Every lane function is held bitwise, lane by lane, to the host SplitMix64
functions that the rest of the port keys with; a lane's draws depend only
on its key and shape, never on the number of lanes; and a model run once
over C lane keys draws for lane i what the same model run on lane i's key
alone draws.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from modppl_tpu_torch.core import keys as K
from modppl_tpu_torch.core.address import addr_hash
from modppl_tpu_torch.core.keys import (
    fold_in,
    fold_in_lanes,
    lane_bits,
    lanes,
    normal_lanes,
    split,
    split_keys,
    split_lanes,
    uniform_lanes,
)
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import (
    bernoulli,
    categorical,
    gamma,
    iid,
    mvnormal,
    normal,
    uniform,
)
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

U64 = st.integers(min_value=0, max_value=(1 << 64) - 1)


def _host(t):
    """int64 lane values as the host's unsigned 64-bit ints."""
    return [int(x) & K._MASK for x in t.reshape(-1)]


@settings(max_examples=60, deadline=None)
@given(key=U64, data=st.lists(U64, min_size=1, max_size=8))
def test_fold_in_lanes_is_host_fold_in(key, data):
    d = torch.tensor([K._signed(x) for x in data], dtype=torch.int64)
    assert _host(fold_in_lanes(key, d)) == [fold_in(key, x) for x in data]
    keys = torch.tensor([K._signed(fold_in(key, i)) for i in
                         range(len(data))], dtype=torch.int64)
    want = [fold_in(fold_in(key, i), x) for i, x in enumerate(data)]
    assert _host(fold_in_lanes(keys, d)) == want
    assert _host(fold_in_lanes(keys, data[0])) == [
        fold_in(fold_in(key, i), data[0]) for i in range(len(data))]


@settings(max_examples=60, deadline=None)
@given(key=U64, c=st.integers(1, 40), num=st.integers(1, 6))
def test_lanes_and_splits_are_host_keys(key, c, num):
    assert _host(lanes(key, c, "cpu")) == [fold_in(key, i) for i in range(c)]
    assert _host(split_keys(key, c, "cpu")) == list(split(key, c))
    ks = lanes(key, c, "cpu")
    got = split_lanes(ks, num)
    assert got.shape == (c, num)
    assert _host(got) == [k for i in range(c)
                          for k in split(fold_in(key, i), num)]


@settings(max_examples=30, deadline=None)
@given(key=U64, k=st.integers(1, 9))
def test_lane_bits_are_mixed_fold_ins(key, k):
    ks = lanes(key, 3, "cpu")
    got = lane_bits(ks, k)
    assert _host(got) == [K._mix(fold_in(fold_in(key, i), j))
                          for i in range(3) for j in range(k)]


@pytest.mark.parametrize("dtype,bits", [(torch.float32, 24),
                                        (torch.float64, 53)])
def test_uniforms_from_the_top_bits_strictly_inside(dtype, bits):
    ks = lanes(5, 20000, "cpu")
    u = uniform_lanes(ks, (3,), dtype)
    assert u.dtype == dtype and u.shape == (20000, 3)
    assert bool((u > 0).all()) and bool((u < 1).all())
    words = lane_bits(ks, 3)
    m = np.array([(x >> (64 - bits)) for x in _host(words)], dtype=np.float64)
    want = np.maximum(m * 2.0 ** -bits, 2.0 ** -(bits + 1))
    np.testing.assert_array_equal(u.double().reshape(-1).numpy(), want)
    # moments of 60000 uniforms: mean 1/2, variance 1/12
    assert abs(float(u.double().mean()) - 0.5) < 5e-3
    assert abs(float(u.double().var()) - 1.0 / 12.0) < 3e-3
    # the words' edge values
    edge = torch.tensor([0, -1], dtype=torch.int64)
    e = K._bits_to_uniform(edge, dtype)
    assert float(e[0]) == 2.0 ** -(bits + 1) and float(e[1]) < 1.0


def test_normals_are_ndtri_of_the_uniforms():
    ks = lanes(9, 50000, "cpu")
    z = normal_lanes(ks, (2,), torch.float64)
    u = uniform_lanes(ks, (2,), torch.float64)
    torch.testing.assert_close(z, torch.special.ndtri(u), rtol=0, atol=0)
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1) < 0.02


@pytest.mark.parametrize("draw", [uniform_lanes, normal_lanes])
def test_a_lane_does_not_depend_on_the_lane_count(draw):
    small = draw(split_keys(4, 37, "cpu"), (5,), torch.float32)
    big = draw(split_keys(4, 74, "cpu"), (5,), torch.float32)
    torch.testing.assert_close(big[:37], small, rtol=0, atol=0)
    one = draw(split_keys(4, 74, "cpu")[11:12], (5,), torch.float32)
    torch.testing.assert_close(one[0], big[11], rtol=0, atol=0)


def test_sample_lanes_shapes_and_rules():
    ks = lanes(3, 6, "cpu")
    x = normal.sample_lanes(ks, (0.0, 1.0))
    assert x.shape == (6,)
    mu = torch.arange(6, dtype=torch.float64)
    y = normal.sample_lanes(ks, (mu, 2.0))
    torch.testing.assert_close(
        y, normal_lanes(ks, (), torch.float64) * 2.0 + mu, rtol=0, atol=0)
    u = uniform.sample_lanes(ks, (1.0, 3.0), dtype=torch.float64)
    torch.testing.assert_close(
        u, uniform_lanes(ks, (), torch.float64) * 2.0 + 1.0, rtol=0, atol=0)
    p = torch.full((6,), 0.3, dtype=torch.float64)
    b = bernoulli.sample_lanes(ks, (p,))
    assert b.dtype == torch.bool
    torch.testing.assert_close(b, uniform_lanes(ks, (), torch.float64) < 0.3)
    probs = torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64)
    c = categorical.sample_lanes(ks, (probs,))
    uu = uniform_lanes(ks, (), torch.float64)
    want = (uu >= 0.2).to(torch.int32) + (uu >= 0.5).to(torch.int32)
    torch.testing.assert_close(c, want, rtol=0, atol=0)
    rows = probs.expand(6, 3)
    assert categorical.sample_lanes(ks, (rows,)).shape == (6,)
    with pytest.raises(ValueError, match="no leading axis"):
        normal.sample_lanes(ks, (torch.zeros(5), 1.0))


def test_large_k_categorical_lanes_follow_the_cdf():
    ks = lanes(8, 40000, "cpu")
    probs = torch.linspace(1.0, 20.0, 20, dtype=torch.float64)
    probs = probs / probs.sum()
    idx = categorical.sample_lanes(ks, (probs,))
    counts = torch.bincount(idx.long(), minlength=20).double()
    expected = 40000 * probs
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 43.8  # the 0.001 quantile of chi-square at 19 d.o.f.


@pytest.mark.parametrize("dist,params", [
    (gamma, (2.0, 1.0)), (iid(gamma, 3), (2.0, 1.0)),
    (iid(mvnormal, 3), (torch.zeros(2), ((1.0, 0.0), (0.0, 1.0))))],
    ids=["gamma", "iid", "iid_mvnormal"])
def test_distributions_without_a_lane_form_raise(dist, params):
    with pytest.raises(NotImplementedError, match="no lane form"):
        dist.sample_lanes(lanes(1, 4, "cpu"), params)


@gen
def _model(h, scale):
    a = h.sample(normal, (0.0, scale), "a")
    b = h.sample(normal, (a, 1.0), "b/x")
    z = h.sample(categorical, (torch.tensor([0.5, 0.25, 0.25],
                                            dtype=torch.float64),), "z")
    h.sample(normal, (b + z, 0.5), "y")
    return b


def test_model_over_lanes_is_each_lane_alone():
    """One generate over C lane keys equals C generates over one key each,
    the draws and the per-lane weights; the sites' lane keys are
    ``fold_in_lanes(keys, addr_hash(addr))``."""
    obs = Trie.from_dict({"y": torch.tensor(0.3, dtype=torch.float64)})
    scale = torch.tensor(2.0, dtype=torch.float64)
    ks = split_keys(17, 12, "cpu")
    tr, w = _model.generate(ks, (scale,), obs)
    assert w.shape == (12,) and tr.logjp.shape == (12,)
    a = normal.sample_lanes(fold_in_lanes(ks, addr_hash("a")), (0.0, scale))
    torch.testing.assert_close(tr.data["a"], a, rtol=0, atol=0)
    for i in (0, 5, 11):
        one, w1 = _model.generate(ks[i:i + 1], (scale,), obs)
        for addr in ("a", "b/x", "z"):
            torch.testing.assert_close(one.data[addr][0], tr.data[addr][i],
                                       rtol=0, atol=0)
        torch.testing.assert_close(w1[0], w[i], rtol=0, atol=0)
    # the weight is each lane's observation log-density
    want = normal.logpdf(obs["y"], (tr.data["b/x"] + tr.data["z"], 0.5))
    torch.testing.assert_close(w, want, rtol=1e-15, atol=1e-15)
    assert math.isfinite(float(tr.logjp.sum()))
