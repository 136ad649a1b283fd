"""PMMH and the chain-blocked filter (``inference/pmcmc.py``,
``inference/blocked_smc.py``), port vs reference on the CPU in float64.

Parity: ``pmmh_kernel``'s accept and carry for a given theta', log-ML and
uniform (the reference's own, from its key split); the chain-blocked
filter's chain c equal to the one-chain filter keyed by chain c's key, and
independent of how many chains run beside it or of a NaN chain among them.
Then the three gates of ``tests/test_pmcmc.py`` at their bounds on the
reference's data (the first at more chains for fewer iterations, as ROADMAP
Queue 3 lists), with the estimator's normal sites held to the reference's
``mvnormal`` kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu.inference import pmcmc as jpmcmc
from modppl_tpu.inference.kalman import kalman_filter as j_kalman_filter
from modppl_tpu.inference.vsmc import particle_filter as j_particle_filter
from modppl_tpu.models.lgssm import lgssm_scan_kernel as j_lgssm_kernel
from modppl_tpu.models.lgssm import lgssm_simulate as j_lgssm_simulate
from modppl_tpu.models.lgssm import make_lgssm as j_make_lgssm
from modppl_tpu_torch.core.keys import split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.inference.blocked_smc import blocked_particle_filter
from modppl_tpu_torch.inference.kalman import kalman_filter
from modppl_tpu_torch.inference.pmcmc import (
    gaussian_walk_proposal,
    pmmh,
    pmmh_kernel,
    smc_log_ml_fn,
)
from modppl_tpu_torch.inference.vsmc import ScanKernel, particle_filter
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.models.lgssm import make_lgssm
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

A_TRUE = 0.7
T = 10
Q, R = 0.2, 0.3


@pytest.fixture(autouse=True)
def _float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _j_params(a):
    one = jnp.ones((1, 1))
    return j_make_lgssm(a * one, Q * one, one, R * one, jnp.zeros(1), one)


def _params(a):
    return make_lgssm([[a]], [[Q]], [[1.0]], [[R]], [0.0], [[1.0]],
                      device="cpu")


def _ys():
    """tests/test_pmcmc.py's data: the reference's simulation at a = 0.7."""
    _, ys = j_lgssm_simulate(jax.random.PRNGKey(0), _j_params(A_TRUE), T)
    return np.asarray(ys)


def make_kernel(a):
    """The 1-D LGSSM with normal sites whose parameters broadcast per lane
    (``a`` a lane tensor): x_0 ~ N(0, 1), x_t ~ N(a x_{t-1}, sqrt(Q)), obs ~
    N(x, sqrt(R))."""
    q, r = math.sqrt(Q), math.sqrt(R)

    @gen
    def init(h, _s0):
        x = h.sample(normal, (0.0, 1.0), "x")
        h.sample(normal, (x, r), "obs")
        return x

    @gen
    def step(h, t, prev):
        x = h.sample(normal, (a * prev, q), "x")
        h.sample(normal, (x, r), "obs")
        return x

    return ScanKernel(init, step)


def _constraints(ys):
    return (Trie.from_dict({"obs": tensor(ys[0, 0])}),
            Trie.from_dict({"obs": tensor(ys[1:, 0])}))


def _exact_mean(ys):
    grid = np.linspace(-0.99, 0.99, 397)
    y = tensor(ys)
    lml = np.array([float(kalman_filter(_params(a), y, device="cpu")
                          ["log_ml"]) for a in grid])
    w = np.exp(lml - lml.max())
    return float((grid * w).sum() / w.sum())


def log_prior(a):
    return torch.where(a.abs() < 0.99, 0.0, -math.inf)


@pytest.mark.parametrize("lp_new,ml_new,key", [
    (0.0, -10.0, 0), (0.0, -14.0, 1), (-math.inf, float("nan"), 2),
    (0.0, -12.3, 3)])
def test_pmmh_kernel_accept_matches_reference(lp_new, ml_new, key):
    """A deterministic proposal, a log-ML function that returns a given
    value and the reference's accept uniform (split(key, 3)[2]): the
    accept flag and the new carry equal the reference kernel's."""
    theta, theta_new, log_post = 0.3, 0.45, -12.0
    jkernel = jpmcmc.pmmh_kernel(
        lambda th: jnp.where(th == theta_new, lp_new, 0.0),
        lambda k, th: jnp.asarray(ml_new), lambda k, th: jnp.asarray(
            theta_new))
    (j_theta, j_lp), j_acc = jkernel(
        jax.random.PRNGKey(key), (jnp.asarray(theta), jnp.asarray(log_post)))
    _, _, k_acc = jax.random.split(jax.random.PRNGKey(key), 3)
    u = torch.tensor([float(jax.random.uniform(k_acc, ()))])
    kernel = pmmh_kernel(
        lambda th: torch.where(th == theta_new, lp_new, 0.0),
        lambda k, th: torch.full((1,), ml_new),
        lambda k, th: torch.full((1,), theta_new))
    (p_theta, p_lp), p_acc = kernel(split_keys(0, 1, "cpu"),
                                    (torch.tensor([theta]),
                                     torch.tensor([log_post])), u=u)
    assert bool(p_acc[0]) == bool(j_acc)
    assert float(p_theta[0]) == float(j_theta)
    assert float(p_lp[0]) == float(j_lp)


def test_gaussian_walk_proposal_per_chain_keys():
    """Each chain's step comes from its own key: chain i's proposal is the
    same among C or 2C chains, and the steps have the stated scale."""
    prop = gaussian_walk_proposal({"a": 0.5, "b": 2.0})
    theta = {"a": torch.zeros(4000), "b": torch.zeros(4000, 2)}
    new = prop(split_keys(3, 4000, "cpu"), theta)
    half = prop(split_keys(3, 2000, "cpu"),
                {"a": torch.zeros(2000), "b": torch.zeros(2000, 2)})
    assert torch.equal(new["a"][:2000], half["a"])
    assert torch.equal(new["b"][:2000], half["b"])
    assert float(new["a"].std()) == pytest.approx(0.5, rel=0.05)
    assert float(new["b"].std()) == pytest.approx(2.0, rel=0.05)


@pytest.mark.parametrize("auto_batch", [False, True])
def test_blocked_filter_chains_are_independent(auto_batch):
    """Chain i's run is bitwise the same among 3 chains, alone, or beside a
    chain whose weights are NaN; on the vmapped tier without resampling it
    is the one-chain particle_filter keyed by chain i's key."""
    ys = _ys()
    ic, sc = _constraints(ys)
    keys = split_keys(7, 3, "cpu")
    a = torch.tensor([0.5, 0.7, -0.2]).repeat_interleave(64)

    def run(keys, a, ess=1.0):
        return blocked_particle_filter(
            keys, make_kernel(a), torch.zeros(()), ic, sc, 64,
            ess_threshold=ess, auto_batch=auto_batch, device="cpu")

    full = run(keys, a)
    alone = run(keys[1:2], a[64:128])
    for k in ("log_ml", "ess", "resampled"):
        assert torch.equal(full[k][..., 1:2], alone[k])
    assert torch.equal(full["ancestors"][:, 64:128] - 64, alone["ancestors"])
    assert torch.equal(full["state"][64:128], alone["state"])
    bad = a.clone()
    bad[:64] = float("nan")
    dirty = run(keys, bad)
    assert not bool(torch.isfinite(dirty["log_ml"][0]))
    assert torch.equal(dirty["log_ml"][1:], full["log_ml"][1:])
    assert torch.equal(dirty["ancestors"][:, 64:], full["ancestors"][:, 64:])
    if not auto_batch:
        one = particle_filter(
            int(keys[1]) % (1 << 64), make_kernel(a[64:128]),
            torch.zeros(()), ic, sc, 64, ess_threshold=0.0,
            store_traces=False, device="cpu")
        blocked = run(keys, a, ess=0.0)
        assert torch.equal(blocked["log_ml"][1], one["log_ml"])
        assert torch.equal(blocked["state"][64:128], one["state"])


def test_pmmh_chain_does_not_depend_on_chain_count():
    ys = _ys()
    ic, sc = _constraints(ys)
    fn = smc_log_ml_fn(make_kernel, torch.zeros(()), ic, sc, 32,
                       device="cpu")
    small = pmmh(5, log_prior, fn, torch.tensor(0.2), num_samples=6,
                 num_chains=2, step_size=0.15, device="cpu")
    large = pmmh(5, log_prior, fn, torch.tensor(0.2), num_samples=6,
                 num_chains=4, step_size=0.15, device="cpu")
    assert torch.equal(large["samples"][:2], small["samples"])
    assert torch.equal(large["log_post"][:2], small["log_post"])


def test_normal_site_estimator_matches_reference_mvnormal_kernel():
    """At a = 0.7 the estimator over normal sites (batched tier, 4 chains
    of 4096) and the reference's mvnormal kernel (its vmapped filter, 4
    keys of 4096) both lie within the reference test's 0.1 of the exact
    Kalman log-ML, and within 0.1 of each other."""
    ys = _ys()
    ic, sc = _constraints(ys)
    exact = float(j_kalman_filter(_j_params(A_TRUE), jnp.asarray(ys))
                  ["log_ml"])
    fn = smc_log_ml_fn(make_kernel, torch.zeros(()), ic, sc, 4096,
                       auto_batch=True, device="cpu")
    ours = float(fn(split_keys(9, 4, "cpu"), torch.full((4,), A_TRUE)).mean())
    jic = JTrie.from_dict({"obs": jnp.asarray(ys[0])})
    jsc = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[JTrie.from_dict({"obs": jnp.asarray(y)}) for y in ys[1:]])
    j_log_ml = jax.jit(lambda k: j_particle_filter(
        k, j_lgssm_kernel(_j_params(A_TRUE)), jnp.zeros(1), jic, jsc, 4096,
        store_traces=False)["log_ml"])
    theirs = np.mean([float(j_log_ml(jax.random.PRNGKey(i)))
                      for i in range(4)])
    assert abs(ours - exact) < 0.1, (ours, exact)
    assert abs(theirs - exact) < 0.1, (theirs, exact)
    assert abs(ours - theirs) < 0.1


def test_pmmh_recovers_transition_coefficient():
    """tests/test_pmcmc.py's gate and bounds, on the vmapped tier (256
    particles, step 0.15). Shortened for tier-1: 8 chains x 300, 75
    burn-in, the same 1,800 kept draws as the reference's 2 chains x 1200
    with 300 burn-in, in a quarter of the iterations (all chains share one
    filter a step, so the host time goes by iterations)."""
    ys = _ys()
    ic, sc = _constraints(ys)
    exact_mean = _exact_mean(ys)
    fn = smc_log_ml_fn(make_kernel, torch.zeros(()), ic, sc, 256,
                       device="cpu")
    out = pmmh(1, log_prior, fn, torch.tensor(0.2), num_samples=300,
               num_chains=8, step_size=0.15, device="cpu")
    pm_mean = float(out["samples"][:, 75:].mean())
    accept = out["accept_rate"]
    assert 0.05 < float(accept.min()) and float(accept.max()) < 0.9, accept
    assert abs(pm_mean - exact_mean) < 0.07, (pm_mean, exact_mean)


def test_pmmh_rejects_out_of_support():
    ys = _ys()
    ic, sc = _constraints(ys)
    inner = smc_log_ml_fn(make_kernel, torch.zeros(()), ic, sc, 64,
                          device="cpu")

    def log_ml_fn(keys, a):
        # keep the estimator finite off the support
        return inner(keys, torch.clamp(a, -0.98, 0.98))

    out = pmmh(2, lambda a: torch.where(a.abs() < 0.3, 0.0, -math.inf),
               log_ml_fn, torch.tensor(0.0), num_samples=300, num_chains=1,
               step_size=0.2, device="cpu")
    assert bool((out["samples"].abs() < 0.3).all())


def test_pmmh_auto_batch_log_ml_matches_kalman():
    ys = _ys()
    ic, sc = _constraints(ys)
    exact = float(kalman_filter(_params(A_TRUE), tensor(ys), device="cpu")
                  ["log_ml"])
    fn = smc_log_ml_fn(make_kernel, torch.zeros(()), ic, sc, 4096,
                       auto_batch=True, device="cpu")
    est = np.mean([float(fn(split_keys(i, 1, "cpu"),
                            torch.tensor([A_TRUE]))[0]) for i in range(4)])
    assert abs(est - exact) < 0.1, (est, exact)
    out = pmmh(5, lambda a: torch.where(a.abs() < 1.0, 0.0, -math.inf), fn,
               torch.tensor(0.4), num_samples=50, num_chains=2,
               step_size=0.15, device="cpu")
    acc = out["accept_rate"]
    assert 0.02 < float(acc.min()) and float(acc.max()) < 0.98, acc


def test_make_lgssm_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """make_lgssm took arrays and lists to the CPU when no device was
    named; it now takes the first tensor argument's device, else the card,
    raising where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="make_lgssm"):
        make_lgssm([[0.5]], [[Q]], [[1.0]], [[R]], [0.0], [[1.0]])
    assert make_lgssm([[0.5]], [[Q]], [[1.0]], [[R]], [0.0], [[1.0]],
                      device="cpu").A.device.type == "cpu"
    p = make_lgssm(torch.tensor([[0.5]]), [[Q]], [[1.0]], [[R]], [0.0],
                   [[1.0]])
    assert p.Q.device.type == "cpu" and p.Q.dtype == torch.float64
