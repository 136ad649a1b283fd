"""The spiral bootstrap particle filter, port vs reference (CPU).

Replayed: the port is fed the reference's own randoms (the plate draws of
every address and each step's resample uniform, rebuilt here from the
reference's keys), so both sides compute the same filter and differ only
by cos/sin/log rounding. Statistical: each side with its own generator.
"""

import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.dists import uniform as j_uniform
from modppl_tpu.modeling.handlers import addr_subkey
from modppl_tpu.models.spiral import spiral_scan_kernel as j_kernel
from modppl_tpu.parallel.sharded_smc import (
    sharded_batched_particle_filter as j_filter,
)
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.interop import tensor, trie_from_numpy
from modppl_tpu_torch.models.spiral import circle_observations, spiral_scan_kernel
from modppl_tpu_torch.parallel.sharded_smc import sharded_batched_particle_filter
from _torch_threads import one_thread  # noqa: F401

T = 10
OBS = np.asarray(circle_observations(T), np.float64)


def _jax_step_c():
    """Per-step constraints stacked over steps, as bench.py builds them."""
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[JTrie.from_dict({"obs": jnp.asarray(o)}) for o in OBS[1:]])


def _jax_filter(seed, n):
    init_c = JTrie.from_dict({"obs": jnp.asarray(OBS[0])})
    return j_filter(None, jax.random.PRNGKey(seed), j_kernel(),
                    jnp.zeros(2, jnp.float64), init_c, _jax_step_c(), n,
                    ess_threshold=1.0, auto_batch=True)


def _port_filter(key, n, replay=None):
    init_c = trie_from_numpy({"obs": OBS[0]})
    step_c = trie_from_numpy({"obs": OBS[1:]})
    return sharded_batched_particle_filter(
        None, key, spiral_scan_kernel(), torch.zeros(2, dtype=torch.float64),
        init_c, step_c, n, ess_threshold=1.0, auto_batch=True, replay=replay,
        device="cpu")


def _reference_draws(seed, n):
    """The reference filter's randoms, rebuilt from its keys: the init's
    plates (vsmc.batched_smc_init), then per step split(key, 4)
    (sharded_smc.py:431), u from fold_in(k_res, 0) and the step plates."""
    def plate(dist, key, addr, params):
        x = dist.sample_batch(addr_subkey(key, addr), (n,), params)
        return tensor(np.asarray(x))

    k_gen, key = jax.random.split(jax.random.PRNGKey(seed))
    replay = [(None, {"r": plate(j_uniform, k_gen, "r", (0.0, 1.0)),
                      "theta": plate(j_uniform, k_gen, "theta",
                                     (0.0, 2.0 * jnp.pi))})]
    for _ in range(T - 1):
        key, k_res, k_gen, _k_rej = jax.random.split(key, 4)
        u = jax.random.uniform(jax.random.fold_in(k_res, 0), (), jnp.float64)
        replay.append((tensor(np.asarray(u)),
                       {"dr": plate(j_normal, k_gen, "dr", (0.0, 0.1)),
                        "dtheta": plate(j_normal, k_gen, "dtheta",
                                        (0.4, 0.2))}))
    return replay


@pytest.mark.parametrize("seed", [0, 5])
def test_spiral_filter_replayed_matches_reference(seed):
    n = 1 << 12
    want = _jax_filter(seed, n)
    got = _port_filter(123, n, replay=_reference_draws(seed, n))
    # the replay makes S identical, so the ancestry is identical too
    np.testing.assert_array_equal(got["ancestors"].numpy(),
                                  np.asarray(want["ancestors"]))
    assert abs(float(got["log_ml"]) - float(want["log_ml"])) < 1e-9
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got["ess"].numpy(), np.asarray(want["ess"]),
                               rtol=1e-9)
    assert bool(got["resampled"].all())


def test_spiral_filter_log_ml_statistically_matches_reference():
    """Independent randoms on each side: the mean log-ML over 8 seeds agrees
    within 4 combined standard errors."""
    n, seeds = 1 << 14, range(8)
    ref = np.array([float(_jax_filter(s, n)["log_ml"]) for s in seeds])
    port = np.array([float(_port_filter(1000 + s, n)["log_ml"])
                     for s in seeds])
    se = math.sqrt(ref.var(ddof=1) / len(ref) + port.var(ddof=1) / len(port))
    assert np.all(np.isfinite(port))
    assert abs(ref.mean() - port.mean()) < 4 * se + 1e-12, (ref, port)


def test_filter_record_then_replay_is_identical():
    """A run's recorded draws replay to the identical filter (the chip
    smoke test's GPU-vs-CPU comparison relies on this)."""
    n = 1 << 10
    rec = []
    first = sharded_batched_particle_filter(
        None, 3, spiral_scan_kernel(), torch.zeros(2), Trie.from_dict(
            {"obs": torch.tensor(OBS[0], dtype=torch.float32)}),
        Trie.from_dict({"obs": torch.tensor(OBS[1:], dtype=torch.float32)}),
        n, auto_batch=True, record=rec, device="cpu")
    again = sharded_batched_particle_filter(
        None, 99, spiral_scan_kernel(), torch.zeros(2), Trie.from_dict(
            {"obs": torch.tensor(OBS[0], dtype=torch.float32)}),
        Trie.from_dict({"obs": torch.tensor(OBS[1:], dtype=torch.float32)}),
        n, auto_batch=True, replay=rec, device="cpu")
    assert len(rec) == T and set(rec[0][1]) == {"r", "theta"}
    assert set(rec[1][1]) == {"dr", "dtheta"}
    assert first["state"].dtype == torch.float32
    assert torch.equal(first["state"], again["state"])
    assert torch.equal(first["log_ml"], again["log_ml"])


@pytest.mark.parametrize("threshold", [0.1, 0.5])
def test_thresholded_resampling_matches_reference_replayed(threshold):
    """ess_threshold < 1: the port selects on the device (torch.where) where
    the reference branches (lax.cond); same filter on the same draws."""
    n = 1 << 10
    init_c = JTrie.from_dict({"obs": jnp.asarray(OBS[0])})
    want = j_filter(None, jax.random.PRNGKey(2), j_kernel(),
                    jnp.zeros(2, jnp.float64), init_c, _jax_step_c(), n,
                    ess_threshold=threshold, auto_batch=True)
    got = sharded_batched_particle_filter(
        None, 0, spiral_scan_kernel(), torch.zeros(2, dtype=torch.float64),
        trie_from_numpy({"obs": OBS[0]}), trie_from_numpy({"obs": OBS[1:]}),
        n, ess_threshold=threshold, auto_batch=True,
        replay=_reference_draws(2, n), device="cpu")
    np.testing.assert_array_equal(got["resampled"].numpy(),
                                  np.asarray(want["resampled"]))
    if threshold < 0.2:  # ESS/N is ~0.2 after a resample: some steps keep
        assert not bool(got["resampled"].all())
    np.testing.assert_array_equal(got["ancestors"].numpy(),
                                  np.asarray(want["ancestors"]))
    assert abs(float(got["log_ml"]) - float(want["log_ml"])) < 1e-9


def test_port_imports_no_jax():
    """An AST scan of every module of the port and of chip_smoke.py: no
    jax, no modppl_tpu."""
    repo = Path(__file__).resolve().parent.parent
    files = sorted((repo / "modppl_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    assert {"hmm.py", "numerics.py", "resample.py", "vsmc.py", "mcmc.py",
            "plate.py", "lgssm.py", "handlers.py", "logreg.py",
            "adaptation.py", "importance.py", "mh.py", "smc.py", "unfold.py",
            "extra.py", "simple.py", "pointed.py",
            "hierarchical.py", "smalllinalg.py", "kalman.py", "enumerate.py",
            "_adam.py", "map_laplace.py", "vi.py", "gp.py", "mala.py",
            "chees.py", "stochvol.py", "blocked_smc.py", "pmcmc.py",
            "pgibbs.py", "fivo.py", "smc_sampler.py",
            "tempering.py"} <= {p.name for p in files}
    files.append(repo / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [(path.name, m) for m in names
                    if m.split(".")[0] in ("jax", "jaxlib", "modppl_tpu")]
    assert not bad, bad
