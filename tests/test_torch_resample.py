"""Resampling kernels' plain versions and the resample step, port vs
reference (CPU).

The reference runs as its own tests run it on a CPU: the XLA path of
_det_grid_positions, _parents_from_s plus a take, and the Pallas kernels in
interpret mode. On CPU tensors the port's kernel wrappers run their plain
versions, which must agree bitwise (the scan, S, ancestors, gathered states)
or, where torch's and XLA's exp may differ by an ulp, at a stated tolerance.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.ops.fused_resample_pallas import (
    resample_fused_from_s as j_resample_fused_from_s,
)
from modppl_tpu.ops.grid_positions_pallas import (
    positions_cummax as j_positions_cummax,
)
from modppl_tpu.ops.grid_positions_pallas import stats_cumsum as j_stats_cumsum
from modppl_tpu.inference.adaptation import _tree_sum as j_tree_sum
from modppl_tpu.parallel import sharded_smc as jsmc
from modppl_tpu_torch.inference.adaptation import _tree_sum
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.ops import fused_resample, grid_positions, resample
from modppl_tpu_torch.parallel import sharded_smc as tsmc
from modppl_tpu_torch.parallel.resample import gather_from_s
from _torch_threads import one_thread  # noqa: F401

N_SCAN = 64 * 1024
CSRC = Path(resample.__file__).resolve().parents[1] / "csrc"


def _lw(kind, n, seed, dtype=np.float32):
    """Log-weights: uniform-ish, concentrated (scale 30) or degenerate (one
    finite weight)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return (rng.standard_normal(n) * 0.7).astype(dtype)
    if kind == "concentrated":
        return (rng.standard_normal(n) * 30.0).astype(dtype)
    lw = np.full(n, -np.inf, dtype)
    lw[rng.integers(n)] = 0.0
    return lw


def _blocked_inputs(lw):
    """cum, offs, total from the reference's XLA path on lw."""
    n = lw.shape[0]
    block = jsmc._cdf_block(n)
    lw_j = jnp.asarray(lw)
    e = jnp.exp(lw_j - jnp.max(lw_j))
    cum = jsmc._doubling_cumsum(e.reshape(-1, block))
    offs_incl = jsmc._doubling_cumsum(cum[:, -1][None, :])[0]
    offs = jnp.concatenate([jnp.zeros((1,), lw_j.dtype), offs_incl[:-1]])
    return np.asarray(cum), np.asarray(offs), np.asarray(offs_incl[-1])


def _jax_s(cum, offs, total, u):
    """S by the reference's XLA path (sharded_smc.py:179-182)."""
    n = cum.size
    cdf = (jnp.asarray(cum) + jnp.asarray(offs)[:, None]).reshape(n)
    return np.asarray(jax.lax.cummax(jnp.clip(
        jnp.ceil((cdf / total) * n - u), 0, n).astype(jnp.int32)))


def _port_s(cum, offs, total, u):
    n = cum.size
    s_rows, mx = grid_positions.positions_cummax(
        tensor(cum), tensor(offs), tensor(total), tensor(u), n)
    prev = torch.cummax(mx, 0).values
    prev = torch.cat([torch.full((1,), -2 ** 31, dtype=torch.int32),
                      prev[:-1]])
    return torch.maximum(s_rows, prev[:, None]).reshape(n).numpy()


@pytest.mark.parametrize("width", [1024, 64, 8])
def test_doubling_cumsum_bitwise(width):
    e = np.random.default_rng(width).exponential(size=(N_SCAN // width, width))
    e = e.astype(np.float32)
    want = np.asarray(jsmc._doubling_cumsum(jnp.asarray(e)))
    got = tsmc._doubling_cumsum(tensor(e)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [8, 1000, 4096])
def test_tree_sum_bitwise(n):
    x = np.random.default_rng(n).standard_normal(n)
    assert float(_tree_sum(tensor(x))) == float(j_tree_sum(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["uniform", "concentrated"])
def test_stats_cumsum_plain_matches_reference(kind):
    """Fed lw, the plain version equals the reference's XLA blocked pass
    up to torch-vs-XLA exp rounding (rtol 4e-7); cum and the row totals also
    match the interpret-mode Pallas kernel. XLA's CPU backend flushes
    subnormal results to zero and torch keeps them, hence the atol of two
    smallest normal float32s (exp(-87) and below)."""
    lw = _lw(kind, N_SCAN, 1)
    m = lw.max()
    tol = dict(rtol=4e-7, atol=2 * np.finfo(np.float32).tiny)
    cum, tot, sq = grid_positions.stats_cumsum(
        tensor(lw).reshape(-1, 1024), tensor(m))
    assert grid_positions.stats_cumsum.launches == 0  # CPU: plain version
    lw_j = jnp.asarray(lw).reshape(-1, 1024)
    e = jnp.exp(lw_j - m)
    c2 = jsmc._doubling_cumsum(jnp.stack([e, e * e]))
    np.testing.assert_allclose(cum.numpy(), np.asarray(c2[0]), **tol)
    np.testing.assert_allclose(tot.numpy(), np.asarray(c2[0, :, -1]), **tol)
    np.testing.assert_allclose(sq.numpy(), np.asarray(c2[1, :, -1]), **tol)
    cum_k, tot_k, _ = j_stats_cumsum(lw_j, jnp.float32(m), interpret=True)
    np.testing.assert_allclose(cum.numpy(), np.asarray(cum_k), **tol)
    np.testing.assert_allclose(tot.numpy(), np.asarray(tot_k), **tol)


@pytest.mark.parametrize("kind", ["uniform", "concentrated", "degenerate"])
def test_positions_bitwise(kind):
    """On the same cum, offs, total and u: S equals the reference's XLA path
    and the interpret-mode positions_cummax kernel, bitwise."""
    lw = _lw(kind, N_SCAN, 2)
    cum, offs, total = _blocked_inputs(lw)
    u = np.float32(0.37)
    got = _port_s(cum, offs, total, u)
    np.testing.assert_array_equal(got, _jax_s(cum, offs, total, u))
    s_rows, mx = j_positions_cummax(jnp.asarray(cum), jnp.asarray(offs),
                                    jnp.asarray(total), jnp.asarray(u),
                                    N_SCAN, interpret=True)
    prev = jax.lax.associative_scan(jnp.maximum, mx)
    prev = jnp.concatenate(
        [jnp.full((1,), jnp.iinfo(jnp.int32).min, jnp.int32), prev[:-1]])
    s_k = np.asarray(jnp.maximum(s_rows, prev[:, None]).reshape(N_SCAN))
    np.testing.assert_array_equal(got, s_k)
    assert grid_positions.positions_cummax.launches == 0


def _sorted_s(kind, n, seed):
    lw = _lw(kind, n, seed)
    cum, offs, total = _blocked_inputs(lw)
    return _jax_s(cum, offs, total, np.float32(0.61))


@pytest.mark.parametrize("c,kind", [(1, "uniform"), (2, "uniform"),
                                    (2, "concentrated"), (7, "concentrated"),
                                    (2, "degenerate")])
def test_gather_bitwise(c, kind):
    """On the same sorted S and state: parents equal _parents_from_s and the
    interpret-mode fused kernel; states equal numpy's take."""
    n = 1024
    s = _sorted_s(kind, n, c)
    state_t = (np.random.default_rng(c).standard_normal((c, n)) * 3.0
               ).astype(np.float32)
    new_t, parents = fused_resample.resample_fused_from_s(
        tensor(s), tensor(state_t))
    want_parents = np.asarray(jsmc._parents_from_s(jnp.asarray(s), n))
    np.testing.assert_array_equal(parents.numpy(), want_parents)
    np.testing.assert_array_equal(
        tsmc._parents_from_s(tensor(s), n).numpy(), want_parents)
    np.testing.assert_array_equal(new_t.numpy(), state_t[:, want_parents])
    k_new, k_parents = j_resample_fused_from_s(
        jnp.asarray(s), jnp.asarray(state_t), interpret=True)
    np.testing.assert_array_equal(parents.numpy(), np.asarray(k_parents))
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(k_new))
    if kind == "degenerate":
        assert len(np.unique(want_parents)) == 1
    # the filter's (N, C) layout and pytree entry give the same result
    new_nc, parents_nc = gather_from_s(tensor(s), tensor(state_t.T.copy()))
    np.testing.assert_array_equal(new_nc.numpy(), state_t[:, want_parents].T)
    np.testing.assert_array_equal(parents_nc.numpy(), want_parents)
    assert fused_resample.resample_fused_from_s.launches == 0


def test_gather_from_s_pytree_state():
    n = 256
    s = _sorted_s("concentrated", n, 3)
    rng = np.random.default_rng(4)
    tree = {"a": tensor(rng.standard_normal(n).astype(np.float32)),
            "b": (tensor(rng.standard_normal((n, 3, 2)).astype(np.float32)),)}
    out, parents = gather_from_s(tensor(s), tree)
    p = parents.numpy()
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"].numpy()[p])
    np.testing.assert_array_equal(out["b"][0].numpy(),
                                  tree["b"][0].numpy()[p])


@pytest.mark.parametrize("shape,layout", [((3, 100), "cn"), ((100, 3), "cn"),
                                          ((3, 64), "nc"), ((64, 3), "xy")])
def test_gather_rejects_mismatched_shapes(shape, layout):
    s = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_resample.resample_fused_from_s(s, torch.zeros(shape), layout)


@pytest.mark.parametrize("kind", ["uniform", "concentrated", "degenerate"])
def test_resample_step_matches_reference(kind):
    """interop carries the reference's (lw, state) and u into the port:
    make_resample_step gives the same S, parents and new state (bitwise)
    and the same d_log_ml (rtol 1e-12). In float64, where torch's and XLA's
    CPU exp agree; in float32 they may differ by an ulp, which can move S
    by one slot at a boundary."""
    dtype = np.float64
    n = 1 << 14
    lw = _lw(kind, n, 5, dtype)
    state = np.random.default_rng(6).standard_normal((n, 2)).astype(dtype)
    key = jax.random.PRNGKey(9)
    u = jax.random.uniform(jax.random.fold_in(key, 0), (), jnp.dtype(dtype))
    j_s, j_log_total, j_ess = jsmc._det_grid_positions(
        jax.random.fold_in(key, 0), jnp.asarray(lw), None, n)
    j_step = jsmc.make_resample_step(None, n, 1.0)
    j_state, j_lw, j_dlml, j_parents, j_ess2, _ = j_step(
        key, jnp.asarray(lw), jnp.asarray(state))

    t_s, t_log_total, t_ess = tsmc._det_grid_positions(
        tensor(np.asarray(u)), tensor(lw), n)
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))
    t_step = tsmc.make_resample_step(None, n, 1.0)
    t_state, t_lw, t_dlml, t_parents, t_ess2, t_do = t_step(
        0, tensor(lw), tensor(state), u=tensor(np.asarray(u)))
    np.testing.assert_array_equal(t_parents.numpy(), np.asarray(j_parents))
    np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))
    np.testing.assert_array_equal(t_lw.numpy(), np.asarray(j_lw))
    np.testing.assert_allclose(float(t_dlml), float(j_dlml), rtol=1e-12)
    np.testing.assert_allclose(float(t_ess2), float(j_ess2), rtol=1e-11)
    assert t_dlml.dtype == torch.float64 and bool(t_do)


@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
def test_det_logsumexp_matches_reference(n):
    lw = np.random.default_rng(n).standard_normal(n) * 4.0
    want = float(jsmc.det_logsumexp(jnp.asarray(lw), None, n))
    got = float(tsmc.det_logsumexp(tensor(lw), n))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("n", [1 << 10, 1 << 16, 1 << 20])
def test_cdf_block_matches_reference(n):
    assert tsmc._cdf_block(n) == jsmc._cdf_block(n)


def _merge_s(kind, m, num, seed):
    """S (m,) int32 sorted in [0, num]: the systematic grid of num slots
    against the CDF of m weights (numpy, float64), or all 0, or all num."""
    if kind == "zeros":
        return np.zeros(m, np.int32)
    if kind == "all_num":
        return np.full(m, num, np.int32)
    lw = _lw(kind, m, seed, np.float64)
    w = np.exp(lw - lw.max())
    cdf = np.cumsum(w) / w.sum()
    s = np.clip(np.ceil(cdf * num - 0.61), 0, num).astype(np.int32)
    return np.maximum.accumulate(s)


@pytest.mark.parametrize("kind,m,num", [
    ("uniform", 4096, 4096), ("concentrated", 4096, 4096),
    ("degenerate", 4096, 4096), ("zeros", 4096, 4096),
    ("all_num", 4096, 4096), ("uniform", 3000, 5000),
    ("concentrated", 7000, 2500), ("degenerate", 2048, 6000),
    ("zeros", 700, 2100), ("all_num", 2100, 700), ("uniform", 1, 1),
    ("zeros", 1, 1), ("all_num", 1, 1), ("uniform", 100_003, 100_003),
    ("concentrated", 100_003, 100_003), ("degenerate", 100_003, 100_003)])
def test_merge_path_model_bitwise(kind, m, num):
    """The rank step as kernels 3 and 4 compute it (resample.
    merge_path_parents, at the tile csrc/rank.cuh compiles in: each CTA's
    two warp searches, its slots in a buffer aligned down to a group, the
    run ends of its window of S marking their slots, the running maximum
    of the marks) writes every slot once within its CTA's buffer and equals
    grid_rank_plain, numpy's searchsorted and, where m = num, parents_from_s
    and the reference's _parents_from_s, bitwise: uniform, concentrated and
    degenerate weights, S all 0 and all num, m != num, N = 1 and N = 100003
    (not a multiple of the tile)."""
    s = _merge_s(kind, m, num, m + num)
    n_in = m
    got = resample.merge_path_parents(tensor(s), n_in, num).numpy()
    want = np.clip(np.searchsorted(s, np.arange(num), side="right"), 0,
                   n_in - 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, resample.grid_rank_plain(tensor(s), n_in, num).numpy())
    if m == num:
        np.testing.assert_array_equal(
            got, fused_resample.parents_from_s(tensor(s), num).numpy())
        np.testing.assert_array_equal(
            got, np.asarray(jsmc._parents_from_s(jnp.asarray(s), num)))
    if kind == "degenerate":
        assert len(np.unique(got)) == 1


def test_rank_layout_matches_csrc():
    """The tile of the CPU model is the one csrc/rank.cuh compiles in (read
    from its two #define lines), meets the header's static_asserts, and
    the launch's blocks cover the num + m merged items, m != num too."""
    src = (CSRC / "rank.cuh").read_text()
    assert f"#define MODPPL_RANK_THREADS {resample.RANK_THREADS}\n" in src
    assert f"#define MODPPL_RANK_ITEMS {resample.RANK_ITEMS}\n" in src
    for num, m in ((100_003, 100_003), (3000, 5000), (7000, 2500), (1, 1)):
        threads, items, blocks = resample.rank_layout(num, m)
        assert threads >= 128 and threads % 32 == 0
        assert items % 4 == 0 and 32 % items == 0
        tile = resample.RANK_TILE
        assert tile == threads * items - items
        assert (blocks - 1) * tile < num + m <= blocks * tile