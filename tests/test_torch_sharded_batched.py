"""The sharded batched-tier filter over gloo ranks (counterpart of
tests/test_sharded_batched.py): one process a shard, spawned once for the
module (tests/_torch_dist.py, cases in tests/_torch_dist_smc.py).

- dp = 1, 2 and 8 of the spiral filter are bitwise equal in every output,
  every step resampling, with a threshold that takes both arms, and with a
  halo of 1 row, which forces the ring exchange every step;
- the resample step at dp = 8 is bitwise the reference's dp = 8 step on
  the reference's log-weights, state and uniform (S, parents, state, the
  log totals, ESS and logsumexp; float64, where torch's and XLA's CPU exp
  and log agree), on the halo path, the ring path and degenerate weights;
- in place of the reference's HLO test, the collectives' byte counts: no
  all-gather larger than the O(N) int32 S, and O(halo C) rows a step by
  ``ppermute`` on the halo path;
- the batch-aware kernel over 8 shards keeps the Kalman gate, and the
  guided and rejuvenated filter is bitwise across dp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.parallel import sharded_smc as jsmc
from modppl_tpu.parallel.mesh import make_mesh as j_make_mesh
from modppl_tpu_torch.ops.fused_resample import parents_from_s
from modppl_tpu_torch.ops.resample import grid_rank, merge_path_parents

from _torch_dist import run_group
from _torch_threads import one_thread  # noqa: F401

WORLD = 8
N = 1024
T = 6
A, Q, R = 0.9, 0.5, 0.3
YS = np.array([0.3, 0.5, 0.1, -0.2, 0.4, 0.9, 0.7, 0.2])
OUTPUTS = ("log_ml", "log_weights", "state", "ancestors", "ess", "resampled")
KEY = jax.random.PRNGKey(9)


def kalman_log_ml(ys):
    """Exact log p(y_1:T) of the scalar model
    (tests/test_batched_filter.py:54-66)."""
    mu, var, total = 0.0, 1.0, 0.0
    for i, y in enumerate(ys):
        if i > 0:
            mu, var = A * mu, A * A * var + Q * Q
        s = var + R * R
        total += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k = var / s
        mu, var = mu + k * (y - mu), (1 - k) * var
    return total


def _kalman_ys():
    """tests/test_sharded_batched.py:138-145's data."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal() * 1.0]
    for _ in range(9):
        xs.append(0.9 * xs[-1] + 0.5 * rng.standard_normal())
    return np.asarray([x + 0.3 * rng.standard_normal() for x in xs],
                      dtype=np.float32)


def _inputs():
    """The reference's inputs of the resample-step cases, float64 (where
    torch's and XLA's CPU exp agree): nearly flat weights (the halo path
    at the default halo), and all mass on particle N - 3."""
    rng = np.random.default_rng(3)
    u = np.asarray(jax.random.uniform(jax.random.fold_in(KEY, 0), (),
                                      jnp.float64))
    deg = np.full(N, -1e30)
    deg[N - 3] = 0.0
    return {"ref_lw": 0.3 * rng.standard_normal(N),
            "ref_state": rng.standard_normal((N, 3)), "ref_u": u,
            "deg_lw": deg,
            "deg_state": np.stack([np.arange(N), 2.0 * np.arange(N)],
                                  1).astype(np.float64),
            "deg_u": u, "kalman_ys": _kalman_ys()}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    inputs = _inputs()
    ranks = run_group("tests._torch_dist_smc", WORLD,
                      tmp_path_factory.mktemp("sharded_batched"), inputs)
    return inputs, ranks


def _same(res, case, dps, keys=OUTPUTS):
    for dp in dps[1:]:
        for k in keys:
            np.testing.assert_array_equal(
                res[f"{case}/dp{dp}/{k}"], res[f"{case}/dp{dps[0]}/{k}"],
                err_msg=f"{case} {k} dp{dp}")


def test_layout_invariance_dp1_dp2_dp8(group):
    _, ranks = group
    res = ranks[0]
    _same(res, "case_layout", (1, 2, WORLD))
    assert res["case_layout/dp1/state"].shape == (N, 2)
    assert bool(res["case_layout/dp1/resampled"].all())
    # every rank of the dp = 8 run holds the same gathered outputs
    for r in ranks[1:]:
        for k in OUTPUTS:
            np.testing.assert_array_equal(
                r[f"case_layout/dp{WORLD}/{k}"],
                res[f"case_layout/dp{WORLD}/{k}"])


def test_layout_invariance_with_ess_threshold(group):
    res = group[1][0]
    resampled = res[f"case_threshold/dp{WORLD}/resampled"]
    assert resampled.any() and not resampled.all()
    _same(res, "case_threshold", (1, WORLD))


def test_layout_invariance_tiny_halo_forces_ring(group):
    res = group[1][0]
    assert int(res["case_tiny_halo/exchanges/ring"]) == T - 1
    assert int(res["case_tiny_halo/exchanges/halo"]) == 0
    _same(res, "case_tiny_halo", (1, WORLD))


def test_collectives_move_no_state_gather(group):
    """Every all_gather of the dp = 8 filter is at most the O(N) int32 S
    (a state gather would be (N, 2) float32, twice that); the exchange of
    rows is by ppermute. On the reference step's halo path a step moves
    exactly two halos of rows."""
    inputs, ranks = group
    res = ranks[0]
    assert 0 < int(res["case_layout/count/all_gather/max_bytes"]) <= 4 * N
    assert int(res["case_layout/count/ppermute/calls"]) > 0
    assert int(res["case_layout/count/host_copies"]) == 0
    halo = max(min(N // WORLD // 4, N // (2 * WORLD)), 1)
    assert int(res["case_reference_step/halo/halo"]) == 1
    assert int(res["case_reference_step/halo/ppermute_bytes"]) == \
        2 * halo * inputs["ref_state"].shape[1] * 8
    assert int(res["case_reference_step/halo/all_gather_max"]) <= 4 * N


def _reference_step(inputs, prefix, halo):
    """The reference's resample step at dp = 8 (its virtual mesh), and its
    S and logsumexp (layout-invariant: the dp = 1 calls)."""
    lw, state = (jnp.asarray(inputs[f"{prefix}_{k}"])
                 for k in ("lw", "state"))
    mesh = j_make_mesh(sp=1)
    step = jax.jit(jsmc.make_resample_step(mesh, N, 1.0, halo=halo))
    with mesh:
        new, lw_out, dml, parents, ess, do = step(KEY, lw, state)
    s, log_total, ess_s = jsmc._det_grid_positions(
        jax.random.fold_in(KEY, 0), lw, None, N)
    lse = jsmc.det_logsumexp(lw, None, N)
    return {"state": new, "parents": parents, "lw": lw_out, "dml": dml,
            "ess": ess, "s": s, "log_total": log_total, "ess_s": ess_s,
            "lse": lse}


@pytest.mark.parametrize("path,prefix,halo", [("halo", "ref", None),
                                               ("ring", "ref", 1),
                                               ("degenerate", "deg", 4)])
def test_resample_step_matches_reference_at_dp8(group, path, prefix, halo):
    inputs, ranks = group
    got = {k.split("/", 2)[2]: v for k, v in ranks[0].items()
           if k.startswith(f"case_reference_step/{path}/")}
    want = {k: np.asarray(v) for k, v in
            _reference_step(inputs, prefix, halo).items()}
    for k in ("s", "parents", "state", "lw", "dml", "log_total", "lse",
              "ess", "ess_s"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got[path if path != "degenerate" else "ring"]) == 1
    if path == "degenerate":
        assert np.all(got["parents"] == N - 3)
        np.testing.assert_array_equal(
            got["state"], np.broadcast_to(inputs["deg_state"][N - 3],
                                          (N, 2)))


def test_sharded_kalman_log_ml_oracle(group):
    """The batch-aware kernel (plate sites on lane keys) at dp = 8 and
    4096 particles, within the reference's 0.05 of the exact log-ML."""
    inputs, ranks = group
    got = float(ranks[0]["case_kalman/log_ml"])
    assert abs(got - kalman_log_ml(inputs["kalman_ys"])) < 0.05


def test_sharded_guided_rejuvenated_layout_invariance(group):
    res = group[1][0]
    _same(res, "case_guided", (1, WORLD), OUTPUTS + ("acceptance",))
    assert abs(float(res[f"case_guided/dp{WORLD}/log_ml"])
               - kalman_log_ml(YS)) < 0.1
    acc = res[f"case_guided/dp{WORLD}/acceptance"]
    assert 0.0 < acc.mean() < 1.0


def test_kernel4_is_parents_from_s_on_the_steps_s(group):
    """Row 4 of the kernel table: the multi-shard step takes the parents
    from the gathered S by grid_rank (kernel 4 on the card). Its plain
    version and its merge-path model are bitwise the reference's scatter
    and cumsum on the S of every case, degenerate (every entry N) and the
    all-N and all-0 vectors included."""
    res = group[1][0]
    cases = [res[f"case_reference_step/{p}/s"]
             for p in ("halo", "ring", "degenerate")]
    cases += [np.full(N, N, np.int32), np.zeros(N, np.int32)]
    assert (cases[2] == N).sum() > 0
    for s in cases:
        s = torch.from_numpy(np.ascontiguousarray(s))
        want = parents_from_s(s, N)
        assert torch.equal(grid_rank(s, N), want)
        assert torch.equal(merge_path_parents(s, N), want)
        j = jsmc._parents_from_s(jnp.asarray(s.numpy()), N)
        np.testing.assert_array_equal(want.numpy(), np.asarray(j))
