"""The port's core, distributions and generate, port vs reference (CPU).

Addresses hash to the reference's values, choice maps cross over through
interop and behave like the reference's tries, and the log-densities agree
with the reference's at rtol 1e-12 in float64 on the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu.core import address as jaddress
from modppl_tpu.dists import mvnormal as j_mvnormal
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.dists import uniform as j_uniform
from modppl_tpu.inference import vsmc as jvsmc
from modppl_tpu.modeling.autobatch import auto_batch_scan_kernel as j_auto_batch
from modppl_tpu.models import spiral as jspiral
from modppl_tpu_torch.core import keys
from modppl_tpu_torch.core.address import addr_components, addr_hash, normalize_addr
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import mvnormal, normal, uniform
from modppl_tpu_torch.dists.mvnormal import cholesky
from modppl_tpu_torch.interop import (
    smc_state_from_numpy,
    tensor,
    trie_from_numpy,
    trie_to_numpy,
)
from modppl_tpu_torch.models import spiral
from _torch_threads import one_thread  # noqa: F401

ADDRESSES = ["r", "theta", "dr", "dtheta", "obs", "a / b", "a/b", " x /y/ z ",
             "steps / 3 / obs", "outer/inner /leaf"]


@pytest.mark.parametrize("addr", ADDRESSES)
def test_address_functions_match_reference(addr):
    assert addr_hash(addr) == jaddress.addr_hash(addr)
    assert addr_hash(addr) == jaddress._py_addr_hash(addr)
    assert normalize_addr(addr) == jaddress.normalize_addr(addr)
    assert addr_components(addr) == tuple(jaddress.addr_components(addr))


def _numpy_dict(d):
    """A reference trie's ``as_dict()`` with every array as numpy."""
    return {k: _numpy_dict(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in d.items()}


def test_trie_round_trip_through_interop():
    rng = np.random.default_rng(0)
    d = {"obs": rng.standard_normal(2), "x": {"y": rng.standard_normal(3),
                                              "z": {"w": np.float64(1.5)}}}
    jtrie = JTrie.from_dict(jax.tree_util.tree_map(jnp.asarray, d))
    port = trie_from_numpy(_numpy_dict(jtrie.as_dict()))
    assert port.addresses() == jtrie.addresses()
    for a in jtrie.addresses():
        assert port[a].dtype == torch.float64
        np.testing.assert_array_equal(port[a].numpy(), np.asarray(jtrie[a]))
    back = trie_to_numpy(port)
    np.testing.assert_array_equal(back["x"]["z"]["w"], d["x"]["z"]["w"])
    np.testing.assert_array_equal(back["obs"], d["obs"])


def _trie_ops(cls, val):
    """The same sequence of writes and removals on either side's trie."""
    t = cls()
    t.w_observe("a / b", val(1.0), val(-0.5))
    t.w_observe("a / c", val(2.0), val(-1.25))
    t.w_observe("d", val(3.0), val(-2.0))
    t.observe("e / f / g", val(4.0))
    with pytest.raises(KeyError):
        t.w_observe("d", val(0.0), val(0.0))
    snap = t.copy()
    removed = t.remove("e / f / g")  # prunes the empty "e / f" and "e"
    inner = t.remove("a / b").take_inner()
    return t, snap, removed, inner


def test_trie_semantics_match_reference():
    p, p_snap, p_removed, p_inner = _trie_ops(Trie, lambda v: torch.tensor(v))
    j, j_snap, j_removed, j_inner = _trie_ops(JTrie, jnp.asarray)
    assert p.addresses() == j.addresses() == ["a / c", "d"]
    assert p_snap.addresses() == j_snap.addresses()
    assert float(p.weight()) == float(j.weight()) == -3.25
    assert float(p_snap.weight()) == float(j_snap.weight())
    assert float(p_inner) == float(j_inner) == 1.0
    assert p_removed.is_leaf() and j_removed.is_leaf()
    assert "e" not in p.children and p.search("e") is None
    assert not p.is_empty() and Trie().is_empty()
    assert p.remove("nowhere") is None and j.remove("nowhere") is None


def test_trie_weight_keeps_the_particle_axis():
    t = Trie()
    t.w_observe("x", torch.zeros(4), torch.arange(4.0))
    t.w_observe("y", torch.zeros(4), torch.ones(4))
    assert torch.equal(t.weight(), torch.arange(4.0) + 1.0)


def _f64(rng, *shape):
    return rng.standard_normal(shape)


def test_uniform_and_normal_logpdfs_match_reference():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-0.5, 7.0, 64), [0.0, 2.0 * np.pi]])
    for params in [(0.0, 1.0), (0.0, 2.0 * np.pi), (-0.25, 3.5)]:
        want = np.asarray(j_uniform.logpdf(jnp.asarray(x), params))
        got = uniform.logpdf(tensor(x), params).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got, want, rtol=1e-12)
    z = _f64(rng, 64) * 2.0
    mu, std = _f64(rng, 64), np.exp(_f64(rng, 64))
    for params in [(0.0, 0.1), (0.4, 0.2)]:
        want = np.asarray(j_normal.logpdf(jnp.asarray(z), params))
        np.testing.assert_allclose(normal.logpdf(tensor(z), params).numpy(),
                                   want, rtol=1e-12)
    want = np.asarray(j_normal.logpdf(jnp.asarray(z), (jnp.asarray(mu),
                                                       jnp.asarray(std))))
    got = normal.logpdf(tensor(z), (tensor(mu), tensor(std))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_mvnormal_logpdf_matches_reference():
    """The spiral's constant OBS_COV (host-factored, broadcast over
    particles) and a batch of per-particle covariances (factored on the
    tensors), each against the reference at rtol 1e-12."""
    rng = np.random.default_rng(2)
    n = 256
    x, mu = _f64(rng, 2), _f64(rng, n, 2) * 0.05
    want = np.asarray(j_mvnormal.logpdf(jnp.asarray(x), (jnp.asarray(mu),
                                                         jspiral.OBS_COV)))
    got = mvnormal.logpdf(tensor(x), (tensor(mu), spiral.OBS_COV)).numpy()
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    a = _f64(rng, n, 3, 3)
    cov = a @ np.swapaxes(a, 1, 2) + 0.5 * np.eye(3)
    x3, mu3 = _f64(rng, n, 3), _f64(rng, n, 3)
    want = np.asarray(j_mvnormal.logpdf(jnp.asarray(x3), (jnp.asarray(mu3),
                                                          jnp.asarray(cov))))
    got = mvnormal.logpdf(tensor(x3), (tensor(mu3), tensor(cov))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    L = cholesky(tensor(cov))
    dense = torch.stack([torch.stack([L[i][j] if j <= i else torch.zeros(n,
                         dtype=torch.float64) for j in range(3)], -1)
                         for i in range(3)], -2)
    np.testing.assert_allclose(dense.numpy(), np.linalg.cholesky(cov),
                               rtol=1e-12, atol=1e-14)


def test_samplers_draw_plates_of_the_right_law():
    """Shapes and dtypes of plate draws, and their first two moments (the
    streams differ from the reference's, so only the law can be held)."""
    g = torch.Generator().manual_seed(0)
    n = 1 << 16
    u = uniform.sample_batch(g, (n,), (0.0, 2.0 * np.pi),
                             dtype=torch.float64)
    assert u.shape == (n,) and u.dtype == torch.float64
    assert 0.0 <= float(u.min()) and float(u.max()) <= 2.0 * np.pi
    assert abs(float(u.mean()) - np.pi) < 5 * 2 * np.pi / np.sqrt(12 * n)
    z = normal.sample_batch(g, (n,), (0.4, 0.2), dtype=torch.float32)
    assert z.dtype == torch.float32
    assert abs(float(z.mean()) - 0.4) < 5 * 0.2 / np.sqrt(n)
    assert abs(float(z.std()) - 0.2) < 0.01
    mu = torch.tensor([[0.3, -0.2]], dtype=torch.float64).expand(n, 2)
    v = mvnormal.sample(g, (mu, ((0.04, 0.01), (0.01, 0.09))))
    assert v.shape == (n, 2)
    c = np.cov(v.numpy().T)
    np.testing.assert_allclose(c, [[0.04, 0.01], [0.01, 0.09]], atol=3e-3)


def test_keys_are_deterministic_and_distinct():
    assert keys.split(7, 4) == keys.split(7, 4)
    derived = set(keys.split(7, 4)) | {keys.fold_in(7, 0), keys.fold_in(8, 0)}
    assert len(derived) == 6
    a = torch.rand(4, generator=keys.generator(keys.fold_in(7, 1), "cpu"))
    b = torch.rand(4, generator=keys.generator(keys.fold_in(7, 1), "cpu"))
    assert torch.equal(a, b)


def test_generate_fully_constrained_matches_reference():
    """One particle, every choice constrained: the port's Gen.generate
    scores the spiral's init and step exactly as the reference does."""
    obs = np.array([0.3, 0.25])
    cons = {"r": 0.45, "theta": 0.7, "obs": obs}
    j_tr, j_w = jspiral.spiral_init.generate(
        jax.random.PRNGKey(0), (jnp.zeros(2),),
        JTrie.from_dict(jax.tree_util.tree_map(jnp.asarray, cons)))
    p_cons = {k: tensor(np.asarray(v, np.float64)) for k, v in cons.items()}
    p_tr, p_w = spiral.spiral_init.generate(
        0, (torch.zeros(2, dtype=torch.float64),), Trie.from_dict(p_cons))
    np.testing.assert_allclose(float(p_w), float(j_w), rtol=1e-12)
    np.testing.assert_allclose(float(p_tr.logjp), float(j_tr.logjp),
                               rtol=1e-12)
    np.testing.assert_allclose(p_tr.retv.numpy(), np.asarray(j_tr.retv),
                               rtol=1e-15)
    step_cons = {"dr": 0.05, "dtheta": 0.3, "obs": obs}
    prev = np.array([0.45, 0.7])
    j_tr, j_w = jspiral.spiral_step.generate(
        jax.random.PRNGKey(1), (1, jnp.asarray(prev)),
        JTrie.from_dict(jax.tree_util.tree_map(jnp.asarray, step_cons)))
    p_tr, p_w = spiral.spiral_step.generate(
        1, (1, tensor(prev)), Trie.from_dict(
            {k: tensor(np.asarray(v, np.float64))
             for k, v in step_cons.items()}))
    np.testing.assert_allclose(float(p_w), float(j_w), rtol=1e-12)
    np.testing.assert_allclose(float(p_tr.logjp), float(j_tr.logjp),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="not all constraints"):
        spiral.spiral_init.generate(0, (torch.zeros(2),), Trie.from_dict(
            {"obs": torch.zeros(2), "nowhere": torch.zeros(())}))


def test_smc_state_crosses_over_through_interop():
    """The reference's batched init state, carried into the port's
    SMCState, keeps its values and dtypes on the given device."""
    n = 64
    kernel = j_auto_batch(jspiral.spiral_scan_kernel())
    s, _ = jvsmc.batched_smc_init(
        jax.random.PRNGKey(3), kernel, jnp.zeros(2),
        JTrie.from_dict({"obs": jnp.asarray([0.4, 0.0])}), n)
    ps = smc_state_from_numpy(5, np.asarray(s.state),
                              np.asarray(s.log_weights),
                              np.asarray(s.log_ml), np.asarray(s.t))
    assert ps.key == 5 and ps.t == int(s.t) == 1
    assert ps.state.shape == (n, 2) and ps.state.dtype == torch.float64
    np.testing.assert_array_equal(ps.state.numpy(), np.asarray(s.state))
    np.testing.assert_array_equal(ps.log_weights.numpy(),
                                  np.asarray(s.log_weights))
    assert float(ps.log_ml) == float(s.log_ml) == 0.0
