"""The vmapped particle filter (``inference/vsmc.smc_init``, ``smc_step``,
``particle_filter``), port vs reference on the CPU.

Parity: the reference's filter stores every particle's draws in its
traces, and its resample uniforms follow from its key split (vsmc.py:
72, 164: ``split(key)``, then ``split(s.key, 4)`` a step); the port is fed
those as ``replay`` and must give the reference's ancestors bitwise and its
log-ML, ESS and states to float64 rounding. Then the six gates of
``tests/test_vsmc.py`` at their sizes and bounds, and one particle's draws
at N and 2N particles.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu import gen as jgen
from modppl_tpu import select as jselect
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.inference import vsmc as jvsmc
from modppl_tpu.modeling.handlers import addr_subkey
from modppl_tpu.models import HMMParams as JHMMParams
from modppl_tpu.models.hmm import hmm_scan_kernel as j_hmm_scan_kernel
from modppl_tpu.models.spiral import spiral_scan_kernel as j_spiral_kernel
from modppl_tpu_torch.core.address import select
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import Standard, normal
from modppl_tpu_torch.inference.smc import ParticleSystem
from modppl_tpu_torch.inference.vsmc import ScanKernel, particle_filter
from modppl_tpu_torch.interop import hmm_params_from_numpy, tensor
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models.hmm import (
    HMM,
    hmm_forward_log_ml,
    hmm_scan_kernel,
)
from modppl_tpu_torch.models.spiral import (
    polar_to_cartesian,
    spiral_scan_kernel,
)
from _torch_threads import one_thread  # noqa: F401

F64 = torch.float64
TOL = dict(rtol=1e-9, atol=1e-12)

PRIOR = [0.2, 0.3, 0.5]
EMISSION = np.array([[0.1, 0.2, 0.7], [0.2, 0.7, 0.1], [0.7, 0.2, 0.1]]).T
TRANSITION = np.array([[0.4, 0.4, 0.2], [0.2, 0.3, 0.5],
                       [0.9, 0.05, 0.05]]).T
DATA = [0, 0, 1, 2]


def _hmm(prior=PRIOR, emission=EMISSION, transition=TRANSITION):
    return hmm_scan_kernel(hmm_params_from_numpy(
        np.asarray(prior), np.asarray(emission), np.asarray(transition)))


def _hmm_constraints(data=DATA):
    return (Trie.from_dict({"obs": torch.tensor(data[0])}),
            Trie.from_dict({"obs": torch.tensor(data[1:])}))


def _exact(prior=PRIOR, emission=EMISSION, transition=TRANSITION, data=DATA):
    return float(hmm_forward_log_ml(prior, emission, transition, data))


def _circle(num, period):
    return [[0.4 * math.cos(2 * math.pi * t / period),
             0.4 * math.sin(2 * math.pi * t / period)] for t in range(num)]


def _spiral_constraints(obs):
    return (Trie.from_dict({"obs": torch.tensor(obs[0], dtype=F64)}),
            Trie.from_dict({"obs": torch.tensor(obs[1:], dtype=F64)}))


def _stack(tries):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *tries)


def _reference(name, resampling, n, seed):
    """The reference's filter and its draws as the port's ``replay``."""
    if name == "hmm":
        kernel = j_hmm_scan_kernel(JHMMParams(
            jnp.asarray(PRIOR), jnp.asarray(EMISSION),
            jnp.asarray(TRANSITION)))
        obs = DATA
        state0, init_addrs, step_addrs = jnp.zeros(()), ("z",), ("z",)
        init_c = JTrie.from_dict({"obs": jnp.asarray(obs[0])})
        step_c = _stack([JTrie.from_dict({"obs": jnp.asarray(o)})
                         for o in obs[1:]])
    else:
        kernel = j_spiral_kernel()
        obs = _circle(6, 16.0)
        state0, init_addrs, step_addrs = (jnp.zeros(2), ("r", "theta"),
                                          ("dr", "dtheta"))
        init_c = JTrie.from_dict({"obs": jnp.asarray(obs[0])})
        step_c = _stack([JTrie.from_dict({"obs": jnp.asarray(o)})
                         for o in obs[1:]])
    key = jax.random.PRNGKey(seed)
    out = jvsmc.particle_filter(key, kernel, state0, init_c, step_c, n,
                                resampling=resampling, ess_threshold=1.0)
    replay = [(None, {a: tensor(np.asarray(out["init_traces"].data[a]))
                      for a in init_addrs})]
    _, s_key = jax.random.split(key)
    for i in range(len(obs) - 1):
        s_key, k_res, _, _ = jax.random.split(s_key, 4)
        shape = () if resampling == "systematic" else (n,)
        u = tensor(np.asarray(jax.random.uniform(k_res, shape, jnp.float64)))
        replay.append((u, {a: tensor(np.asarray(out["step_traces"].data[a][i]))
                           for a in step_addrs}))
    return out, replay, obs


@pytest.mark.parametrize("name,resampling", [
    ("hmm", "systematic"), ("hmm", "multinomial"),
    ("spiral", "systematic"), ("spiral", "multinomial")])
def test_particle_filter_matches_reference_on_its_draws(name, resampling):
    n = 512
    want, replay, obs = _reference(name, resampling, n, seed=3)
    if name == "hmm":
        kernel, state0 = _hmm(), torch.zeros((), dtype=F64)
        init_c, step_c = _hmm_constraints()
    else:
        kernel, state0 = spiral_scan_kernel(), torch.zeros(2, dtype=F64)
        init_c, step_c = _spiral_constraints(obs)
    got = particle_filter(0, kernel, state0, init_c, step_c, n,
                          resampling=resampling, replay=replay, device="cpu")
    np.testing.assert_array_equal(got["ancestors"].numpy(),
                                  np.asarray(want["ancestors"]))
    np.testing.assert_array_equal(got["resampled"].numpy(),
                                  np.asarray(want["resampled"]))
    np.testing.assert_allclose(float(got["log_ml"]), float(want["log_ml"]),
                               **TOL)
    np.testing.assert_allclose(got["ess"].numpy(), np.asarray(want["ess"]),
                               **TOL)
    np.testing.assert_allclose(got["log_weights"].numpy(),
                               np.asarray(want["log_weights"]), **TOL)
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]),
                               **TOL)
    assert got["step_traces"].data["obs"].shape[0] == len(obs) - 1


# the scalar linear-Gaussian SSM of tests/test_batched_filter.py and its
# locally optimal proposal, in both DSLs
A, Q, R = 0.9, 0.5, 0.3
YS = [0.3, 0.5, 0.1, -0.2, 0.4, 0.9]
PREC = 1.0 / Q ** 2 + 1.0 / R ** 2


def _lg(dist):
    def init(h, _s0):
        x = h.sample(dist, (0.0, 1.0), "x")
        h.sample(dist, (x, R), "y")
        return x

    def step(h, t, prev):
        x = h.sample(dist, (A * prev, Q), "x")
        h.sample(dist, (x, R), "y")
        return x

    def prop(h, t, prev, cons):
        m = (A * prev / Q ** 2 + cons.read("y") / R ** 2) / PREC
        h.sample(dist, (m, 1.0 / math.sqrt(PREC)), "x")

    return init, step, prop


J_LG = [jgen(f) for f in _lg(j_normal)]
T_LG = [gen(f) for f in _lg(normal)]


def _normals(keys, addr):
    return tensor(np.asarray(jax.vmap(lambda k: jax.random.normal(
        addr_subkey(k, addr), (), jnp.float64))(keys)))


def test_guided_rejuvenated_filter_matches_reference_on_its_draws():
    """The guided arm (particle i's lane split into the proposal's key and
    the model's) and one regenerative move of x a step, on the
    reference's draws rebuilt from its key chain."""
    n, key = 256, jax.random.PRNGKey(9)
    jinit, jstep, jprop = J_LG
    want = jvsmc.particle_filter(
        key, jvsmc.ScanKernel(jinit, jstep), jnp.zeros(()),
        JTrie.from_dict({"y": jnp.asarray(YS[0])}),
        _stack([JTrie.from_dict({"y": jnp.asarray(y)}) for y in YS[1:]]), n,
        proposal=jprop, rejuvenation=(jselect("x"), 1))
    replay = [(None, {"x": tensor(np.asarray(want["init_traces"].data["x"]))})]
    _, s_key = jax.random.split(key)
    for _ in YS[1:]:
        s_key, k_res, k_gen, k_rej = jax.random.split(s_key, 4)
        u = tensor(np.asarray(jax.random.uniform(k_res, (), jnp.float64)))
        k_prop = jax.vmap(lambda k: jax.random.split(k)[0])(
            jax.random.split(k_gen, n))
        k_move = jax.vmap(lambda k: jax.random.split(
            jax.random.fold_in(k, 0)))(jax.random.split(k_rej, n))
        acc = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(
            k_move[:, 1])
        replay.append((u, {}, {"x": Standard(_normals(k_prop, "x"))},
                       [({"x": Standard(_normals(k_move[:, 0], "x"))},
                         tensor(np.asarray(acc)))]))
    tinit, tstep, tprop = T_LG
    got = particle_filter(
        0, ScanKernel(tinit, tstep), torch.zeros((), dtype=F64),
        Trie.from_dict({"y": torch.tensor(YS[0], dtype=F64)}),
        Trie.from_dict({"y": torch.tensor(YS[1:], dtype=F64)}), n,
        proposal=tprop, rejuvenation=(select("x"), 1), replay=replay,
        device="cpu")
    np.testing.assert_array_equal(got["ancestors"].numpy(),
                                  np.asarray(want["ancestors"]))
    np.testing.assert_allclose(float(got["log_ml"]), float(want["log_ml"]),
                               **TOL)
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]),
                               **TOL)
    acc = got["acceptance"].numpy()
    assert acc.shape == (len(YS) - 1, 1) and 0 < acc.mean() < 1


def test_record_then_replay_is_identical():
    """A run's recorded draws replay to the identical filter, with
    rejuvenation moves (their draws and accept uniforms) too."""
    init_c, step_c = _hmm_constraints()
    kw = dict(rejuvenation=(select("z"), 2), device="cpu")
    record = []
    a = particle_filter(5, _hmm(), torch.zeros((), dtype=F64), init_c, step_c,
                        256, record=record, **kw)
    b = particle_filter(6, _hmm(), torch.zeros((), dtype=F64), init_c, step_c,
                        256, replay=record, **kw)
    for k in ("ancestors", "state", "log_weights", "acceptance"):
        assert torch.equal(a[k], b[k]), k
    assert float(a["log_ml"]) == float(b["log_ml"])


def test_a_particle_draws_the_same_at_n_and_2n():
    """Particle i's init draws come from its own key, whatever N."""
    init_c, step_c = _spiral_constraints(_circle(3, 16.0))
    outs = [particle_filter(8, spiral_scan_kernel(),
                            torch.zeros(2, dtype=F64), init_c, step_c, n,
                            device="cpu") for n in (300, 600)]
    for a in ("r", "theta"):
        small, big = (o["init_traces"].data[a] for o in outs)
        assert torch.equal(big[:300], small)


def test_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init_c, step_c = _hmm_constraints()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        particle_filter(0, _hmm(), torch.zeros(()), init_c, step_c, 64)
    out = particle_filter(0, _hmm(), torch.zeros(()), init_c, step_c, 64,
                          device="cpu")
    assert out["log_ml"].device.type == "cpu"


# --------------------------------------------------------------------------
# tests/test_vsmc.py's gates, at its sizes and bounds
# --------------------------------------------------------------------------

def test_vsmc_hmm_lml_gate():
    init_c, step_c = _hmm_constraints()
    out = particle_filter(0, _hmm(), torch.zeros(()), init_c, step_c, 10_000,
                          resampling="multinomial", device="cpu")
    assert float(out["log_ml"]) == pytest.approx(_exact(), abs=0.03)
    out2 = particle_filter(1, _hmm(), torch.zeros(()), init_c, step_c,
                           10_000, resampling="systematic", device="cpu")
    assert float(out2["log_ml"]) == pytest.approx(_exact(), abs=0.03)


def test_vsmc_hmm_adaptive_resampling():
    prior, em, tr = [0.5, 0.5], [[0.9, 0.1], [0.1, 0.9]], [[0.8, 0.2],
                                                            [0.2, 0.8]]
    data = [0, 0, 1, 1, 0]
    init_c, step_c = _hmm_constraints(data)
    out = particle_filter(2, _hmm(prior, em, tr), torch.zeros(()), init_c,
                          step_c, 5000, resampling="systematic",
                          ess_threshold=0.5, device="cpu")
    assert float(out["log_ml"]) == pytest.approx(
        _exact(prior, em, tr, data), abs=0.05)
    assert not bool(out["resampled"].all())


def test_vsmc_spiral_tracking():
    t = 12
    obs = _circle(t, t)
    init_c, step_c = _spiral_constraints(obs)
    out = particle_filter(3, spiral_scan_kernel(), torch.zeros(2, dtype=F64),
                          init_c, step_c, 2000, resampling="systematic",
                          device="cpu")
    final = polar_to_cartesian(out["state"])
    lw = out["log_weights"] - torch.logsumexp(out["log_weights"], 0)
    mean = torch.sum(torch.exp(lw)[:, None] * final, 0)
    assert float(torch.linalg.norm(mean - torch.tensor(obs[-1], dtype=F64))) \
        < 0.1
    assert math.isfinite(float(out["log_ml"]))
    assert out["ancestors"].shape == (t - 1, 2000)


def test_vsmc_matches_eager_reference_engine():
    prior, em, tr = [0.3, 0.7], np.array([[0.6, 0.4], [0.2, 0.8]]).T, \
        np.array([[0.7, 0.3], [0.4, 0.6]]).T
    data = [1, 0, 1]
    exact = _exact(prior, em, tr, data)
    init_c, step_c = _hmm_constraints(data)
    out = particle_filter(4, _hmm(prior, em, tr), torch.zeros(()), init_c,
                          step_c, 4000, device="cpu")
    assert float(out["log_ml"]) == pytest.approx(exact, abs=0.05)
    params = hmm_params_from_numpy(np.asarray(prior), em, tr)
    pf = ParticleSystem(HMM(params), 300, 5, device="cpu")
    pf.init_step(None, ([None], [data[0]]))
    for o in data[1:]:
        pf.step(([None], [o]))
        pf.resample()
    assert float(pf.log_marginal_likelihood_estimate()) == pytest.approx(
        exact, abs=0.3)


def test_vsmc_rejuvenation_preserves_target():
    init_c, step_c = _hmm_constraints()
    out = particle_filter(11, _hmm(), torch.zeros(()), init_c, step_c, 10_000,
                          rejuvenation=(select("z"), 2), device="cpu")
    assert float(out["log_ml"]) == pytest.approx(_exact(), abs=0.03)
    assert out["acceptance"].shape == (len(DATA) - 1, 2)


def test_vsmc_rejuvenation_improves_spiral_ess():
    obs = _circle(10, 16.0)
    init_c, step_c = _spiral_constraints(obs)
    base = particle_filter(12, spiral_scan_kernel(), torch.zeros(2, dtype=F64),
                           init_c, step_c, 1000, device="cpu")
    rej = particle_filter(12, spiral_scan_kernel(), torch.zeros(2, dtype=F64),
                          init_c, step_c, 1000,
                          rejuvenation=(select("dr", "dtheta"), 3),
                          device="cpu")
    assert math.isfinite(float(rej["log_ml"]))
    assert float(rej["ess"].min()) >= 0.5 * float(base["ess"].min())
