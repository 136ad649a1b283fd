"""One lane stream a particle and a chain: a particle's or a chain's draws
are keyed by its global index, so they are the same whatever the
particle or chain count, and a shard holding the indices [k, k + n) draws
exactly what one device draws for them (the layout invariance that the
multi-shard tests, tests/test_torch_sharded*.py, hold end to end).

- the batched tier (modeling/autobatch.py): every site of an auto-batched
  init, step, proposal and regenerate, the rejuvenation's accept
  uniforms, and a ``Map`` called under it;
- the generic HMC path, ChEES and MALA: each segment's pre-drawn randoms
  (``hmc._lane_draws``) and whole per-chain runs.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from modppl_tpu_torch.core import Trie, select
from modppl_tpu_torch.core.gfi import ArgDiff
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.inference.vsmc import ScanKernel
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.autobatch import (
    AutoBatchedPropose,
    auto_batch_scan_kernel,
)
from modppl_tpu_torch.modeling.map_combinator import Map
from modppl_tpu_torch.models.spiral import spiral_scan_kernel

from _torch_threads import one_thread  # noqa: F401

# the submodules (the package exports functions of the same names)
chees, hmc, mala, vsmc = (importlib.import_module(
    f"modppl_tpu_torch.inference.{m}") for m in ("chees", "hmc", "mala",
                                                 "vsmc"))
F64 = torch.float64
N = 64


def _halves(fn):
    """fn(n, offset) at (2N, 0) and at (N, 0), (N, N)."""
    return fn(2 * N, 0), fn(N, 0), fn(N, N)


def _hold_halves(whole, first, second):
    assert torch.equal(whole[:N], first)
    assert torch.equal(whole[N:], second)


def test_batched_tier_particle_draws_do_not_depend_on_n():
    """Particle i's draws at every site of the spiral's init and step are
    the same among N or 2N particles, and a shard at offset N draws the
    second half."""
    kernel = auto_batch_scan_kernel(spiral_scan_kernel())
    obs = Trie.from_dict({"obs": torch.tensor([0.3, 0.1], dtype=F64)})

    def init(n, offset):
        trace, w = kernel.init.generate(5, (torch.zeros(2, dtype=F64), n),
                                        obs, offset=offset)
        return trace, w

    def step(n, offset):
        prev = torch.linspace(0.1, 0.9, 2 * N, dtype=F64)[offset:offset + n]
        prev = torch.stack([prev, 2 * prev], -1)
        return kernel.step.generate(9, (1, prev), obs, offset=offset)

    for fn, addrs in ((init, ("r", "theta")), (step, ("dr", "dtheta"))):
        (whole, w_whole), (first, w1), (second, w2) = _halves(fn)
        for a in addrs:
            _hold_halves(whole.data[a], first.data[a], second.data[a])
        _hold_halves(w_whole, w1, w2)


@gen
def lg_step(h, t, prev):
    x = h.sample(normal, (0.9 * prev, 0.5), "x")
    h.sample(normal, (x, 0.3), "y")
    return x


@gen
def lg_proposal(h, t, prev, cons):
    h.sample(normal, (0.9 * prev + 0.1 * cons.read("y"), 0.4), "x")


def test_proposal_regenerate_and_accepts_do_not_depend_on_n():
    """A batched proposal, a batched regenerate and the rejuvenation's
    accept uniforms: particle i's the same at N and 2N, and at offset N
    the second half."""
    kernel = auto_batch_scan_kernel(ScanKernel(lg_step, lg_step))
    prop = AutoBatchedPropose(lg_proposal)
    obs = Trie.from_dict({"y": torch.tensor(0.4, dtype=F64)})
    prev_all = torch.linspace(-1.0, 1.0, 2 * N, dtype=F64)

    def propose(n, offset):
        prev = prev_all[offset:offset + n]
        choices, logjp = prop.propose(3, (1, prev, obs), n, offset=offset)
        return torch.stack([choices["x"], logjp])

    def moved(n, offset):
        prev = prev_all[offset:offset + n]
        trace, _ = kernel.step.generate(1, (1, prev), obs, offset=offset)
        new, w = kernel.step.regenerate(4, trace, trace.args,
                                        ArgDiff.NO_CHANGE, select("x"),
                                        offset=offset)
        after, accepts = vsmc._rejuvenate(6, trace, kernel, select("x"), 2,
                                          offset=offset)
        return torch.stack([new.data["x"], w, after.data["x"],
                            accepts[0].to(F64), accepts[1].to(F64)])

    for fn in (propose, moved):
        whole, first, second = _halves(fn)
        _hold_halves(whole.T, first.T, second.T)


@gen
def point(h, mu, x):
    return h.sample(normal, (mu * x, 0.1), "y")


@gen
def plated_step(h, t, slope):
    """A step whose Map runs under the batched tier: one plate of n = 3
    points a particle."""
    s = h.sample(normal, (slope, 0.2), "slope")
    xs = torch.tensor([1.0, 2.0, 3.0], dtype=F64)
    h.trace(Map(point, shared=(1,)), (s[..., None] + torch.zeros_like(xs),
                                      xs), "ys")
    return s


def test_map_under_the_batched_tier():
    """A ``Map`` called in an auto-batched body runs over the particles'
    lane keys at its address, one lane a particle: its (n_particles, 3)
    draws are particle i's at N and 2N, and its constrained weight is per
    particle."""
    kernel = auto_batch_scan_kernel(ScanKernel(plated_step, plated_step))
    slopes = torch.linspace(-1.0, 1.0, 2 * N, dtype=F64)

    def run(n, offset, obs=None):
        trace, w = kernel.step.generate(
            2, (1, slopes[offset:offset + n]),
            Trie() if obs is None else obs, offset=offset)
        return trace.data["ys / y"], w

    (whole, _), (first, _), (second, _) = _halves(run)
    assert whole.shape == (2 * N, 3)
    _hold_halves(whole, first, second)
    obs = Trie.from_dict({"ys": {"y": torch.tensor([0.5, 1.1, 1.4],
                                                   dtype=F64)}})
    _, w = run(N, 0, obs)
    assert w.shape == (N,) and bool(torch.isfinite(w).all())
    assert float(w.std()) > 0


@pytest.mark.parametrize("module,jitter", [(hmc, True), (chees, False)])
def test_phase_randoms_do_not_depend_on_the_chain_count(module, jitter):
    """A segment's momenta, jitters and accept uniforms: chain i's the
    same among C or 2C chains, and at offset C the second half."""
    def draws(c, offset):
        return module._phase_randoms(11, c, 5, 3, F64, "cpu", offset)

    whole, first, second = _halves(draws)
    assert len(whole) == (3 if jitter else 2)
    for w, a, b in zip(whole, first, second):
        assert torch.equal(w[:, :N], a) and torch.equal(w[:, N:], b)
    assert whole[0].shape == (5, 2 * N, 3)


def test_mala_phase_draws_do_not_depend_on_the_chain_count():
    u4 = torch.zeros(4, 3, dtype=F64)
    u8 = torch.zeros(8, 3, dtype=F64)
    d4 = list(mala._phase_draws(3, 70, u4))
    d8 = list(mala._phase_draws(3, 70, u8))
    assert len(d4) == len(d8) == 70
    for (n4, a4), (n8, a8) in zip(d4, d8):
        assert torch.equal(n8[:4], n4) and torch.equal(a8[:4], a4)


@gen
def scale_model(h):
    mu = h.sample(normal, (0.0, 2.0), "mu")
    h.sample(normal, (mu, 1.0), "x")


def _x_obs():
    return Trie.from_dict({"x": torch.tensor(0.7, dtype=F64)})


@pytest.mark.parametrize("sampler", ["hmc", "mala"])
def test_per_chain_runs_do_not_depend_on_the_chain_count(sampler):
    """With per-chain adaptation chain i's whole run, start point included,
    is the same among 4 or 8 chains."""
    def run(c):
        if sampler == "hmc":
            return hmc.hmc(3, scale_model, (), _x_obs(), num_chains=c,
                           num_warmup=30, num_samples=10, num_leapfrog=3,
                           pooled_adaptation=False,
                           use_fused_quadratic=False, device="cpu")
        return mala.mala(3, scale_model, (), _x_obs(), num_chains=c,
                         num_warmup=30, num_samples=10, device="cpu")

    four, eight = run(4), run(8)
    assert torch.equal(eight["unconstrained"][:4], four["unconstrained"])
    assert torch.equal(eight["step_size"][:4], four["step_size"])
    assert not torch.equal(eight["unconstrained"][4:],
                           eight["unconstrained"][:4])


def test_start_points_are_the_chains_lane_draws():
    """hmc_runner's start points: chain i's jitter keyed ``split(k_run,
    C)[i]``, the same at any C, at offset k the chains from k."""
    u0 = torch.tensor([0.5, -1.0], dtype=F64)
    whole = hmc.start_points(7, u0, 2 * N)
    _hold_halves(whole, hmc.start_points(7, u0, N),
                 hmc.start_points(7, u0, N, offset=N))
    assert abs(float((whole - u0).std()) - 0.5) < 0.1
    assert math.isfinite(float(whole.sum()))
    np.testing.assert_array_equal(whole.shape, (2 * N, 2))
