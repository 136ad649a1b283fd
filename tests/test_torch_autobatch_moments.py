"""The reference's last uncovered SMC and auto-batch gates, run on the port
(CPU, float64): three of tests/test_autobatch.py's four tests (lines
86-200) and tests/test_spiral_lgssm_moments.py, at the reference's sizes
and bounds. The data are simulated as the reference's are, from the same
numpy seeds (the spiral LGSSM's by the port's own ``lgssm_simulate``, whose
streams are not threefry's)."""

import math

import numpy as np
import pytest
import torch

from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.inference.kalman import (
    kalman_filter_parallel,
    kalman_smoother_parallel,
)
from modppl_tpu_torch.inference.vsmc import (
    ScanKernel,
    batched_particle_filter,
    particle_filter,
)
from modppl_tpu_torch.models.lgssm import (
    lgssm_scan_kernel,
    lgssm_simulate,
    make_lgssm,
)
from modppl_tpu_torch.models.spiral import spiral_scan_kernel
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

F64 = torch.float64
A, Q, R = 0.9, 0.5, 0.3


def _spiral_constraints(num_steps):
    obs = torch.tensor([[0.4 * np.cos(2 * np.pi * t / 16),
                         0.4 * np.sin(2 * np.pi * t / 16)]
                        for t in range(num_steps)], dtype=F64)
    return Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]})


def test_auto_batch_matches_vmapped_tier_statistically():
    """Auto-batched and per-particle-vmapped tiers estimate the same
    log-ML (different streams; agreement within Monte Carlo error)."""
    n, T = 4096, 8
    init_c, step_c = _spiral_constraints(T)
    auto = batched_particle_filter(
        0, spiral_scan_kernel(), torch.zeros(2, dtype=F64), init_c, step_c,
        n, ess_threshold=1.0, auto_batch=True, device="cpu")
    vmapped = particle_filter(
        1, spiral_scan_kernel(), torch.zeros(2, dtype=F64), init_c, step_c,
        n, ess_threshold=1.0, store_traces=False, device="cpu")
    assert float(auto["log_ml"]) == pytest.approx(float(vmapped["log_ml"]),
                                                  abs=1.0)


def _lg_data(seed, T):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0)
    ys = []
    for t in range(T):
        if t > 0:
            x = A * x + rng.normal(0.0, Q)
        ys.append(x + rng.normal(0.0, R))
    return ys


def _kalman_evidence(ys):
    mu, var, total = 0.0, 1.0, 0.0
    for t, y in enumerate(ys):
        if t > 0:
            mu, var = A * mu, A * A * var + Q * Q
        s = var + R * R
        total += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k = var / s
        mu, var = mu + k * (y - mu), (1 - k) * var
    return total


def _lg_constraints(ys):
    ys = torch.tensor(ys, dtype=F64)
    return Trie.from_dict({"y": ys[0]}), Trie.from_dict({"y": ys[1:]})


def test_auto_batch_state_dependent_latents():
    """Latents whose parameters depend on the particle state stay correct
    under auto_batch: the scalar LG model against the exact Kalman
    evidence (data simulated from the model, numpy seed 3)."""

    @gen
    def lg_init(h, _s0):
        x = h.sample(normal, (0.0, 1.0), "x")
        h.sample(normal, (x, R), "y")
        return x

    @gen
    def lg_step(h, t, prev):
        x = h.sample(normal, (A * prev, Q), "x")
        h.sample(normal, (x, R), "y")
        return x

    ys = _lg_data(3, 10)
    init_c, step_c = _lg_constraints(ys)
    out = batched_particle_filter(
        2, ScanKernel(lg_init, lg_step), torch.zeros((), dtype=F64), init_c,
        step_c, 8192, ess_threshold=1.0, auto_batch=True, device="cpu")
    assert float(out["log_ml"]) == pytest.approx(_kalman_evidence(ys),
                                                 abs=0.05)


def test_auto_batch_subtrace_calls_get_distinct_lane_streams():
    """Kernels with nested h.trace sub-calls under auto_batch: each lane's
    sub-call draws from its own stream (the states do not collapse), and
    the filter matches the exact evidence (numpy seed 5)."""

    @gen
    def noise_source(h, scale):
        return h.sample(normal, (0.0, scale), "eps")

    @gen
    def lg2_init(h, _s0):
        x = h.trace(noise_source, (1.0,), "xsub")
        h.sample(normal, (x, 0.3), "y")
        return x

    @gen
    def lg2_step(h, t, prev):
        eps = h.trace(noise_source, (0.5,), "xsub")
        x = 0.9 * prev + eps
        h.sample(normal, (x, 0.3), "y")
        return x

    ys = _lg_data(5, 8)
    init_c, step_c = _lg_constraints(ys)
    out = batched_particle_filter(
        6, ScanKernel(lg2_init, lg2_step), torch.zeros((), dtype=F64),
        init_c, step_c, 8192, ess_threshold=1.0, auto_batch=True,
        device="cpu")
    assert float(torch.std(out["state"])) > 0.05
    assert float(out["log_ml"]) == pytest.approx(_kalman_evidence(ys),
                                                 abs=0.12)


DR_STD, DTH_STD, DRIFT = 0.1, 0.2, 0.4
OBS_STD = 0.15
EPS = 1e-10  # pseudo-variance of the constant drift component


def _spiral_lgssm():
    # state (r, theta, 1): the drift enters theta through the constant
    return make_lgssm(
        np.array([[1.0, 0.0, 0.0], [0.0, 1.0, DRIFT], [0.0, 0.0, 1.0]]),
        np.diag([DR_STD ** 2, DTH_STD ** 2, EPS]),
        np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
        OBS_STD ** 2 * np.eye(2), np.array([0.5, 0.0, 1.0]),
        np.diag([0.05, 0.3, EPS]), device="cpu")


def test_spiral_smc_moments_match_parallel_kalman():
    """tests/test_spiral_lgssm_moments.py: the vmapped filter with stored
    traces at N = 32768, T = 12 against kalman_filter_parallel /
    kalman_smoother_parallel: the log-ML within 0.1, the filtered mean
    within 0.02 and covariance within 5e-4 at T, the smoothed means along
    the ancestry within 0.05."""
    params = _spiral_lgssm()
    T, N = 12, 32768
    _, ys = lgssm_simulate(0, params, T)
    exact_f = kalman_filter_parallel(params, ys, device="cpu")
    exact_s = kalman_smoother_parallel(params, ys, device="cpu")
    out = particle_filter(1, lgssm_scan_kernel(params),
                          torch.zeros(3, dtype=F64),
                          Trie.from_dict({"obs": ys[0]}),
                          Trie.from_dict({"obs": ys[1:]}), N,
                          ess_threshold=1.0, store_traces=True, device="cpu")
    assert float(out["log_ml"]) == pytest.approx(float(exact_f["log_ml"]),
                                                 abs=0.1)
    w = torch.softmax(out["log_weights"], 0)
    xT = out["state"]
    mean_T = w @ xT
    torch.testing.assert_close(mean_T[:2], exact_f["means"][-1, :2],
                               rtol=0, atol=0.02)
    cov_T = (w[:, None] * (xT - mean_T)).T @ (xT - mean_T)
    torch.testing.assert_close(cov_T[:2, :2], exact_f["covs"][-1, :2, :2],
                               rtol=0, atol=5e-4)
    states = torch.cat([out["init_traces"].retv[None],
                        out["step_traces"].retv])           # (T, N, 3)
    ancestors = out["ancestors"].long()                    # (T - 1, N)
    traj = torch.empty_like(states)
    idx = torch.arange(N)
    for t in range(T - 1, -1, -1):
        traj[t] = states[t][idx]
        if t > 0:
            idx = ancestors[t - 1][idx]
    smoothed = torch.einsum("n,tnd->td", w, traj)
    torch.testing.assert_close(smoothed[:, :2], exact_s["means"][:, :2],
                               rtol=0, atol=0.05)
    assert math.isfinite(float(out["log_ml"]))
