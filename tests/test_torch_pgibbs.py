"""Conditional SMC and particle Gibbs (``inference/pgibbs.py``), port vs
reference on the CPU in float64.

Bitwise on given values: ``_score_at`` on the reference's own trace,
``_splice0`` and the backtracking on given choices and parents (the
reference's ``lax.scan(..., reverse=True)`` of pgibbs.py:167-176). The
ancestor-sampling score draws nothing. ``mvnormal``'s lane form is its
``from_standard`` of the lane's standard normals. Then the three gates of
``tests/test_pgibbs.py`` at their bounds, on the reference's data (the two
particle-Gibbs runs shortened, as ROADMAP Queue 3 lists).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu.inference import pgibbs as jpg
from modppl_tpu.inference.kalman import kalman_filter as j_kalman_filter
from modppl_tpu.inference.kalman import kalman_smoother as j_kalman_smoother
from modppl_tpu.models.lgssm import lgssm_scan_kernel as j_lgssm_kernel
from modppl_tpu.models.lgssm import lgssm_simulate as j_lgssm_simulate
from modppl_tpu.models.lgssm import make_lgssm as j_make_lgssm
from modppl_tpu_torch.core.keys import lanes, normal_lanes
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import mvnormal
from modppl_tpu_torch.inference import pgibbs
from modppl_tpu_torch.inference.pgibbs import csmc_sweep, particle_gibbs
from modppl_tpu_torch.interop import tensor, trace_from_reference
from modppl_tpu_torch.models.lgssm import lgssm_scan_kernel, make_lgssm
from _torch_threads import one_thread  # noqa: F401

T = 6


@pytest.fixture(autouse=True)
def _float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _setup():
    """tests/test_pgibbs.py:20-31, both sides on the reference's data."""
    one = jnp.ones((1, 1))
    jparams = j_make_lgssm(0.8 * one, 0.3 * one, one, 0.4 * one,
                           jnp.zeros(1), one)
    _, ys = j_lgssm_simulate(jax.random.PRNGKey(0), jparams, T)
    ys = np.asarray(ys)
    params = make_lgssm([[0.8]], [[0.3]], [[1.0]], [[0.4]], [0.0], [[1.0]],
                        device="cpu")
    return (jparams, ys, lgssm_scan_kernel(params),
            Trie.from_dict({"obs": tensor(ys[0])}),
            Trie.from_dict({"obs": tensor(ys[1:])}))


def test_score_at_and_splice0_match_reference():
    jparams, ys, _, _, _ = _setup()
    jk = j_lgssm_kernel(jparams)
    tr, _ = jk.step.generate(jax.random.PRNGKey(3), (1, jnp.ones(1)),
                             JTrie.from_dict({"obs": jnp.asarray(ys[1])}))
    ours = pgibbs._score_at(trace_from_reference(tr), ("obs", "x"))
    assert float(ours) == float(jpg._score_at(tr, ("obs", "x")))
    rng = np.random.default_rng(0)
    batched = {"a": rng.standard_normal((5, 2)), "b": rng.standard_normal(5)}
    pinned = {"a": rng.standard_normal(2), "b": np.float64(0.25)}
    want = jpg._splice0(jax.tree_util.tree_map(jnp.asarray, batched),
                        jax.tree_util.tree_map(jnp.asarray, pinned))
    got = pgibbs._splice0({k: tensor(v) for k, v in batched.items()},
                          {k: tensor(v) for k, v in pinned.items()})
    for k in batched:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_backtracking_matches_reference_scan():
    """Given choices (T-1, N, 2) and parents (T-1, N) and a final index,
    the port's reversed loop of gathers equals the reference's reversed
    scan, bitwise."""
    rng = np.random.default_rng(1)
    n, steps = 9, 7
    choices = rng.standard_normal((steps, n, 2))
    parents = rng.integers(0, n, size=(steps, n)).astype(np.int32)
    choices0 = rng.standard_normal((n, 2))
    j_final = np.int32(4)

    def back(j, inp):
        choices_t, parents_t = inp
        return parents_t[j], {"x": choices_t["x"][j]}

    j0, want = jax.lax.scan(back, jnp.asarray(j_final),
                            ({"x": jnp.asarray(choices)},
                             jnp.asarray(parents)), reverse=True)
    k0, got = pgibbs._backtrack(
        torch.tensor(j_final), [{"x": tensor(c)} for c in choices],
        [tensor(p) for p in parents])
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    assert int(k0[0]) == int(j0)
    np.testing.assert_array_equal(
        torch.index_select(tensor(choices0), 0, k0)[0].numpy(),
        choices0[int(j0)])


def test_ancestor_score_draws_nothing():
    """The ancestor-sampling score of every particle is one fully
    constrained generate: its weights are the reference's vmapped score
    (generate under a placeholder key), and a reference that leaves a
    latent of the step free raises rather than drawing it."""
    jparams, ys, kernel, _, _ = _setup()
    states = np.random.default_rng(2).standard_normal((7, 1))
    full = {"obs": ys[2], "x": np.array([0.3])}
    jk = j_lgssm_kernel(jparams)
    want = jax.vmap(lambda s: jk.step.generate(
        jax.random.PRNGKey(0), (2, s),
        JTrie.from_dict({k: jnp.asarray(v) for k, v in full.items()}))[1])(
        jnp.asarray(states))
    got = pgibbs._ref_scores(kernel, 2, tensor(states), Trie.from_dict(
        {k: tensor(v) for k, v in full.items()}), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="would draw"):
        pgibbs._ref_scores(kernel, 2, tensor(states),
                           Trie.from_dict({"obs": tensor(ys[2])}), 7)


def test_mvnormal_lane_form_is_from_standard():
    """mvnormal under lane keys: lane i's draw is mu + L z_i for its own
    standard normals (``from_standard``), with shared or per-lane means,
    and the first C lanes of 2C are the C draws."""
    cov = tensor(np.array([[1.0, 0.3], [0.3, 0.5]]))
    mu = tensor(np.random.default_rng(3).standard_normal((6, 2)))
    ks = lanes(4, 6, "cpu")
    z = normal_lanes(ks, (2,), torch.float64)
    for m in (mu, mu[0]):
        got = mvnormal.sample_lanes(ks, (m, cov))
        assert torch.equal(got, mvnormal.from_standard(z, (m, cov)))
    L = np.linalg.cholesky(cov.numpy())
    np.testing.assert_allclose(
        mvnormal.from_standard(z, (mu, cov)).numpy(),
        mu.numpy() + z.numpy() @ L.T, rtol=1e-12, atol=1e-12)
    wide = mvnormal.sample_lanes(lanes(4, 12, "cpu"), (mu[0], cov))
    assert torch.equal(wide[:6], mvnormal.sample_lanes(ks, (mu[0], cov)))


def test_particle_gibbs_matches_kalman_smoother():
    """tests/test_pgibbs.py's gate and bounds; shortened for tier-1 to 500
    sweeps with 100 burn-in (the reference: 1500 and 300; chip_smoke.py's
    phase 29 runs that)."""
    jparams, ys, kernel, ic, sc = _setup()
    smth = j_kalman_smoother(jparams, jnp.asarray(ys))
    out = particle_gibbs(1, kernel, torch.zeros(1), ic, sc,
                         latent_init_addrs=("x",), latent_step_addrs=("x",),
                         num_particles=32, num_sweeps=500, device="cpu")
    xs0 = out["init"]["x"][100:, 0].numpy()
    xs_rest = out["steps"]["x"][100:, :, 0].numpy()
    traj = np.concatenate([xs0[:, None], xs_rest], axis=1)
    exact_means = np.asarray(smth["means"])[:, 0]
    exact_sds = np.sqrt(np.asarray(smth["covs"])[:, 0, 0])
    np.testing.assert_allclose(traj.mean(axis=0), exact_means, atol=0.12)
    np.testing.assert_allclose(traj.std(axis=0), exact_sds, atol=0.12)


def test_csmc_sweep_log_ml_and_pinning():
    jparams, ys, kernel, ic, sc = _setup()
    out = csmc_sweep(2, kernel, torch.zeros(1), ic, sc,
                     {"x": torch.zeros(1)}, {"x": torch.zeros((T - 1, 1))},
                     num_particles=512, device="cpu")
    exact = float(j_kalman_filter(jparams, jnp.asarray(ys))["log_ml"])
    assert abs(float(out["log_ml"]) - exact) < 1.0
    assert out["ref_init"]["x"].shape == (1,)
    assert out["ref_steps"]["x"].shape == (T - 1, 1)


def test_particle_gibbs_without_ancestor_sampling():
    """tests/test_pgibbs.py's gate and bound; shortened for tier-1 to 500
    sweeps with 100 burn-in (the reference: 1500 and 300; phase 29 runs
    that)."""
    jparams, ys, kernel, ic, sc = _setup()
    smth = j_kalman_smoother(jparams, jnp.asarray(ys))
    out = particle_gibbs(3, kernel, torch.zeros(1), ic, sc,
                         latent_init_addrs=("x",), latent_step_addrs=("x",),
                         num_particles=64, num_sweeps=500,
                         ancestor_sampling=False, device="cpu")
    xT = out["steps"]["x"][100:, -1, 0].numpy()
    assert abs(xT.mean() - float(smth["means"][-1, 0])) < 0.12
