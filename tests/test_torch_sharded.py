"""Meshes, the vmapped filter over shards, the cross-shard resampler and
logsumexp, the two-process runs and the checkpointed sharded filter, over
gloo ranks (counterpart of tests/test_sharded.py, tests/test_multiprocess.py
and the dp = 8 case of tests/test_checkpointed.py's sharded resume): one
process a shard, spawned once for the module (tests/_torch_dist.py, cases
in tests/_torch_dist_filters.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu.parallel.distributed import shardmap_resample_fn
from modppl_tpu.parallel.mesh import make_mesh as j_make_mesh
from modppl_tpu.models import hmm_forward_alg

from _torch_dist import run_group
from _torch_threads import one_thread  # noqa: F401

WORLD = 8
HMM_DATA = [0, 0, 1, 2]
PRIOR = np.array([0.2, 0.3, 0.5])
EMISSION = np.array([[0.1, 0.2, 0.7], [0.2, 0.7, 0.1], [0.7, 0.2, 0.1]]).T
TRANSITION = np.array([[0.4, 0.4, 0.2], [0.2, 0.3, 0.5],
                       [0.9, 0.05, 0.05]]).T
YS = np.array([0.3, 0.5, 0.1, -0.2, 0.4, 0.9, 0.7, 0.2])


def _resample_inputs(prefix, seed, n, cols, normalized):
    rng = np.random.default_rng(seed)
    lw = rng.standard_normal(n)
    if normalized:
        lw = lw - np.logaddexp.reduce(lw)
    state = rng.standard_normal((n, cols))
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (), jnp.float64))
    return {f"{prefix}_lw": lw, f"{prefix}_state": state, f"{prefix}_u": u}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("sharded")
    inputs = {"hmm_prior": PRIOR, "hmm_emission": EMISSION,
              "hmm_transition": TRANSITION, "lg_ys": YS,
              "lse_lw": np.random.default_rng(2).standard_normal(4096) * 3.0,
              "workdir": np.asarray(str(workdir / "ckpt")),
              **_resample_inputs("rs", 4, 1024, 3, False),
              **_resample_inputs("mp", 42, 1024, 2, True)}
    (workdir / "ckpt").mkdir()
    ranks = run_group("tests._torch_dist_filters", WORLD, workdir / "group",
                      inputs)
    return inputs, ranks


def _exact_hmm():
    return float(np.log(np.asarray(hmm_forward_alg(
        jnp.asarray(PRIOR), jnp.asarray(EMISSION), jnp.asarray(TRANSITION),
        HMM_DATA))))


def test_mesh_shapes(group):
    ranks = group[1]
    assert int(ranks[0]["case_mesh_shapes/world_size"]) == WORLD
    assert int(ranks[0]["case_mesh_shapes/world_dp"]) == WORLD
    assert int(ranks[0]["case_mesh_shapes/grid_dp"]) == 4
    assert int(ranks[0]["case_mesh_shapes/grid_sp"]) == 2
    # row-major: rank r sits at (r // 2, r % 2); a particle sharding
    # splits a leading axis over dp (4 rows), a data sharding over sp (2),
    # replicated keeps it whole
    x = np.arange(16)
    for r, res in enumerate(ranks):
        i, j = r // 2, r % 2
        assert tuple(res["case_mesh_shapes/grid_coords"]) == (i, j)
        np.testing.assert_array_equal(res["case_mesh_shapes/particles"],
                                      x[4 * i:4 * i + 4])
        np.testing.assert_array_equal(res["case_mesh_shapes/data"],
                                      x[8 * j:8 * j + 8])
        np.testing.assert_array_equal(res["case_mesh_shapes/replicated"], x)
        np.testing.assert_array_equal(res["case_mesh_shapes/constrained"], x)


def test_sharded_particle_filter_accuracy(group):
    res = group[1][0]
    got = float(res["case_vmapped_filter/sharded16000/log_ml"])
    assert got == pytest.approx(_exact_hmm(), abs=0.03)


def test_sharded_matches_unsharded_bitwise(group):
    """The vmapped filter over 8 shards is the one-device filter: each
    particle draws by its global lane key and every shard resamples the
    whole gathered system."""
    res = group[1][0]
    for k in ("log_ml", "state", "log_weights", "ancestors"):
        np.testing.assert_array_equal(
            res[f"case_vmapped_filter/sharded8000/{k}"],
            res[f"case_vmapped_filter/one8000/{k}"], err_msg=k)


def test_distributed_logsumexp(group):
    inputs, ranks = group
    want = float(np.logaddexp.reduce(inputs["lse_lw"]))
    for r in ranks:
        assert float(r["case_logsumexp/lse"]) == pytest.approx(want,
                                                               abs=1e-10)


def test_shardmap_resample_deterministic_across_shard_counts(group):
    """Bitwise the same at dp = 1, 2, 4 (of a 4 x 2 mesh) and 8, on the
    port's own uniform; and on the reference's uniform bitwise the
    reference's resampler on its 8-device mesh."""
    inputs, ranks = group
    res = ranks[0]
    case = "case_resample_across_shard_counts"
    for dp in (2, "4x2", WORLD):
        for k in ("state", "parents", "log_total", "drawn_parents"):
            np.testing.assert_array_equal(res[f"{case}/dp{dp}/{k}"],
                                          res[f"{case}/dp1/{k}"],
                                          err_msg=f"{dp} {k}")
    mesh = j_make_mesh(sp=1)
    with mesh:
        new_state, parents, log_total = shardmap_resample_fn(mesh)(
            jax.random.PRNGKey(7), jnp.asarray(inputs["rs_lw"]),
            jnp.asarray(inputs["rs_state"]))
    np.testing.assert_array_equal(res[f"{case}/dp{WORLD}/parents"],
                                  np.asarray(parents))
    np.testing.assert_array_equal(res[f"{case}/dp{WORLD}/state"],
                                  np.asarray(new_state))
    assert float(res[f"{case}/dp{WORLD}/log_total"]) == pytest.approx(
        float(log_total), rel=1e-12)
    # parents concentrate on the high-weight particles
    top = np.argsort(inputs["rs_lw"])[-1024 // 8:]
    assert np.isin(res[f"{case}/dp1/drawn_parents"], top).mean() > 0.35


def test_two_process_resample_matches_single_process(group):
    """tests/test_multiprocess.py: the resampler over two processes is
    bitwise its one-process run, and (on the reference's uniform) the
    reference's 8-device run."""
    inputs, ranks = group
    res = ranks[0]
    case = "case_two_process_resample"
    for k in ("state", "parents", "log_total", "drawn_parents"):
        np.testing.assert_array_equal(res[f"{case}/dp2/{k}"],
                                      res[f"{case}/dp1/{k}"], err_msg=k)
    mesh = j_make_mesh(sp=1)
    with mesh:
        new_state, parents, _ = shardmap_resample_fn(mesh)(
            jax.random.PRNGKey(7), jnp.asarray(inputs["mp_lw"]),
            jnp.asarray(inputs["mp_state"]))
    np.testing.assert_array_equal(res[f"{case}/dp2/parents"],
                                  np.asarray(parents))
    np.testing.assert_array_equal(res[f"{case}/dp2/state"],
                                  np.asarray(new_state))


@pytest.mark.parametrize("mode", ["filter", "guided"])
def test_two_process_sharded_filter_matches_single_process(group, mode):
    res = group[1][0]
    for k in ("state", "log_weights", "log_ml", "ancestors"):
        np.testing.assert_array_equal(
            res[f"case_two_process_filter/{mode}/dp2/{k}"],
            res[f"case_two_process_filter/{mode}/dp1/{k}"], err_msg=k)


def test_sharded_filter_checkpoint_resume_bitwise(group):
    """A run interrupted at step 3 and resumed from its checkpoint is
    bitwise the uninterrupted one, at dp = 1 and dp = 8; the uninterrupted
    one is the one-shot filter; dp = 1 and dp = 8 agree."""
    res = group[1][0]
    case = "case_checkpoint_resume"
    for dp in (1, WORLD):
        for k in ("state", "log_weights", "log_ml", "t"):
            np.testing.assert_array_equal(res[f"{case}/dp{dp}/full/{k}"],
                                          res[f"{case}/dp{dp}/resumed/{k}"],
                                          err_msg=f"dp{dp} {k}")
        np.testing.assert_array_equal(res[f"{case}/dp{dp}/full/state"],
                                      res[f"{case}/dp{dp}/one_shot/state"])
    for k in ("state", "log_weights", "log_ml"):
        np.testing.assert_array_equal(res[f"{case}/dp1/full/{k}"],
                                      res[f"{case}/dp{WORLD}/full/{k}"])
    assert int(res[f"{case}/dp1/full/t"]) == 9
