"""Pooled adaptation and HMC-family samplers over gloo ranks
(counterparts of the dp tests of tests/test_pooled_adaptation.py,
tests/test_chees.py::test_shardmap_chees_matches_single_device,
tests/test_sharded.py::test_sharded_hmc_runs and the pooled-HMC case of
tests/test_multiprocess.py): one process a shard, spawned once for the
module (tests/_torch_dist.py, cases in tests/_torch_dist_mcmc.py). Chains
draw by their global index and pool through fixed add trees, so the runs
are bitwise the same at dp = 1, 2 and 8 on these models, whose
log-densities are elementwise in the chains."""

import jax.numpy as jnp
import numpy as np
import pytest

from modppl_tpu.inference.adaptation import _pooled_sum as j_pooled_sum

from _torch_dist import run_group
from _torch_threads import one_thread  # noqa: F401

WORLD = 8


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {"x": rng.standard_normal((64, 3)),
              "u0s": 0.5 * rng.standard_normal((16, 2))}
    ranks = run_group("tests._torch_dist_mcmc", WORLD,
                      tmp_path_factory.mktemp("sharded_mcmc"), inputs)
    return inputs, ranks


def _same(res, case, dps, keys):
    for dp in dps[1:]:
        for k in keys:
            np.testing.assert_array_equal(
                res[f"{case}/dp{dp}/{k}"], res[f"{case}/dp{dps[0]}/{k}"],
                err_msg=f"{case} {k} dp{dp}")


def test_pooled_sum_blocked_matches_shardmap(group):
    """The local tree-partials all-gathered in shard order and tree-summed
    are the reference's one tree over all 64 chains, at dp = 1, 2, 8."""
    inputs, ranks = group
    want = np.asarray(j_pooled_sum(jnp.asarray(inputs["x"]), None))
    for dp in (1, 2, WORLD):
        np.testing.assert_array_equal(
            ranks[0][f"case_pooled_sum/dp{dp}/sum"], want)


def test_pooled_warmup_bitwise_unsharded_vs_shardmap(group):
    _same(group[1][0], "case_pooled_warmup", (1, WORLD),
          ("us", "eps", "inv_mass"))


def test_pooled_hmc_bitwise_dp1_vs_dp8(group):
    res = group[1][0]
    _same(res, "case_shardmap_hmc", (1, WORLD),
          ("step_size", "inv_mass", "unconstrained", "accept_prob"))
    assert res["case_shardmap_hmc/dp1/unconstrained"].shape == (16, 20, 2)


def test_two_process_pooled_hmc_matches_single_process(group):
    _same(group[1][0], "case_two_process_hmc", (1, 2),
          ("step_size", "unconstrained", "accept_prob"))


def test_shardmap_chees_matches_single_device(group):
    res = group[1][0]
    _same(res, "case_shardmap_chees", (1, WORLD),
          ("step_size", "trajectory_length", "num_leapfrog",
           "unconstrained", "accept_prob"))


def test_sharded_hmc_runs(group):
    mus = group[1][0]["case_sharded_hmc/mu"].ravel()
    assert mus.size == 64 * 200
    assert mus.mean() == pytest.approx(0.5, abs=0.08)


def test_nuts_axis_name_bitwise_dp1_vs_dp8(group):
    _same(group[1][0], "case_nuts", (1, WORLD),
          ("step_size", "unconstrained", "accept_prob"))
