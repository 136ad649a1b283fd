"""chip_smoke.py's phases 43-47 (slice 13) on the CPU at a small width.

Each case runs one of ``slice13_phases``' own arm drivers with
``device="cpu"``, where every kernel wrapper computes its plain version
and no kernel launches: the same entry points, gates, reruns through the
plain versions and digests that the card runs at full width, here at a few
hundred to a few thousand lanes and short chains, so that the script's
code cannot rot unseen. Phase 47's ranks are two spawned gloo processes
(dp = 2) running ``slice13_rank``; no rank imports JAX.
"""

import os

import pytest

import chip_smoke as cs
from _torch_threads import one_thread  # noqa: F401

CPU = "cpu"


@pytest.mark.parametrize("entry", cs.LG_ENTRIES)
@pytest.mark.parametrize("arm", cs.LG_ARMS)
def test_phase43_batched_tier_arm(entry, arm):
    seen = cs.check_lg_arm(entry, arm, CPU, n=1 << 15)
    assert seen["launches"] == {}
    assert (seen["acceptance"] is None) == (arm != "guided")


def test_phase43_vmapped_guided_and_rejuvenated():
    seen = cs.check_lg_vmapped(CPU, n=2048)
    assert "log_ml_cpu" not in seen and seen["launches"] == {}


@pytest.mark.parametrize("scheme", cs.S13_SCHEMES)
def test_phase44_blocked_scheme(scheme):
    seen = cs.check_blocked_scheme(scheme, CPU, num_chains=2, n=4096,
                                   iters=4)
    assert seen["dtype"] == ("float64" if scheme == "systematic"
                             else "float32")


def test_phase44_fivo_resampled():
    seen = cs.check_fivo_resampled(CPU, dict(cs.S13_FIVO, num_steps=250),
                                   grad_particles=1024)
    assert seen["grad_launches"] == 0 and seen["grad_max_diff"] == 0.0


@pytest.mark.parametrize("arm", ["nuts_per_chain", "hmc_per_chain",
                                 "hmc_scale", "pt_mala"])
def test_phase45_generic_mcmc_arm(arm):
    if arm == "nuts_per_chain":
        cs.check_nuts_per_chain(CPU, dict(cs.S13_NUTS_PER_CHAIN,
                                          num_warmup=30, num_samples=30))
    elif arm == "hmc_per_chain":
        cs.check_hmc_per_chain(CPU, config=(16, 60, 60),
                               oracle_draws=100_000)
    elif arm == "hmc_scale":
        cs.check_hmc_scale(CPU, dict(num_chains=64, num_warmup=60,
                                     num_samples=60))
    else:
        cs.check_pt_mala(CPU, dict(cs.PT, num_rounds=200, burn=50))


@pytest.mark.parametrize("arm", ["switch", "pointed", "map", "mvnormal"])
def test_phase46_modeling_arm(arm):
    n = {"switch": 4096, "pointed": 1 << 15, "map": 512,
         "mvnormal": 1 << 14}[arm]
    fn = {"switch": cs.check_switch, "pointed": cs.check_pointed,
          "map": cs.check_map_arms, "mvnormal": cs.check_mvnormal_nonpd}[arm]
    fn(CPU, n=n)


def test_phase47_distributed_entries(tmp_path, monkeypatch):
    """The spawned ranks at dp = 2 over gloo (``spawn_shards(...,
    groups="47")``), then phase 47's checks against dp = 1 and the
    one-device vmapped filter in this process."""
    for var in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH"):
        monkeypatch.delenv(var, raising=False)
    chains = dict(cs.S13_SHARD_CHAINS, num_chains=16)
    seen, _, _ = cs.spawn_shards(str(tmp_path), 2, CPU, "gloo", timeout=240.0,
                                 groups="47", pf_particles=512,
                                 pow2_chains=chains["num_chains"])
    assert os.path.exists(tmp_path / "slice12.json")
    runs = cs.check_sharded_entries(seen, 2, CPU, n=512,
                                    chains_config=chains)
    assert set(runs) >= {"pf/dp1", "pf/dp2", "nuts/dp2", "sharded_hmc/dp2"}
