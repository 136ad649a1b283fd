"""The port's eager particle filter, ``Unfold`` and the hand-coded ``HMM``
against the JAX package's (CPU, float64).

Parity on the same inputs: the reference's HMM traces through the port's
``HMM.generate`` / ``update`` (the port's draw of the new state matched to
the reference's) and its spiral ``Unfold`` traces through the port's
``Unfold.generate`` / ``update`` on fully constrained steps, weights,
log-joints, states and choices at 1e-12; ``ParticleSystem`` on the
reference's particles, step by step: log-weights, ESS, each resample's
log-ML update and the log-ML estimate at 1e-10. Then what draws decide:
step t's key is ``fold_in(key, t)``, resampling follows the weights (a
chi-square gate), and the reference's own gates: the ``Unfold`` EXTEND
contract with hand-computed weights (tests/test_smc_unfold.py:84-157), the
HMM's log-ML within 0.25 of the exact forward algorithm's
(tests/test_particle_filter.py:38-67) and spiral tracking
(tests/test_smc_unfold.py:60-81); ``Trace.copy``; and ``device=``
defaulting to the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import ArgDiff as JArgDiff
from modppl_tpu import Trie as JTrie
from modppl_tpu.inference import ParticleSystem as JParticleSystem
from modppl_tpu.models import HMM as JHMM
from modppl_tpu.models import HMMParams as JHMMParams
from modppl_tpu.models import spiral_model as j_spiral_model
from modppl_tpu_torch.core import ArgDiff, Trie
from modppl_tpu_torch.core.gfi import Trace
from modppl_tpu_torch.core.keys import fold_in
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.inference import ParticleSystem
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.unfold import Unfold
from modppl_tpu_torch.models import HMM, HMMParams, hmm_forward_alg
from modppl_tpu_torch.interop import trace_from_reference
from modppl_tpu_torch.models import spiral_model
from modppl_tpu_torch.models.spiral import polar_to_cartesian, spiral_kernel
from _torch_threads import one_thread  # noqa: F401

CPU = "cpu"
PRIOR = [0.2, 0.3, 0.5]
EMISSION = np.array([[0.1, 0.2, 0.7], [0.2, 0.7, 0.1], [0.7, 0.2, 0.1]]).T
TRANSITION = np.array([[0.4, 0.4, 0.2], [0.2, 0.3, 0.5],
                       [0.9, 0.05, 0.05]]).T
TOL = dict(rtol=0.0, atol=1e-12)
PF_TOL = dict(rtol=0.0, atol=1e-10)


@pytest.fixture(autouse=True)
def float64_default():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def circle(timesteps, init_angle, radius=0.4):
    """Observation tries of points on a circle (tests/test_smc_unfold.py's
    ``simulate_loop``, the start angle given)."""
    obs = []
    for t in range(timesteps):
        ang = 2 * math.pi * t / timesteps + init_angle
        c = Trie()
        c.observe("obs", torch.tensor([radius * math.cos(ang),
                                       radius * math.sin(ang)]))
        obs.append(c)
    return obs


def test_unfold_simulate_generate_update():
    trace = spiral_model.simulate(0, (3, torch.zeros(2)))
    assert len(trace.data) == 3 and len(trace.retv) == 3
    assert trace.data[0].search("r") is not None
    assert trace.data[1].search("dr") is not None
    assert np.isfinite(float(trace.logjp))

    obs = circle(3, 0.7)
    gtrace, w = spiral_model.generate(0, (3, torch.zeros(2)), obs)
    assert np.isfinite(float(w))
    for t in range(3):
        assert torch.equal(gtrace.data[t].read("obs"), obs[t].read("obs"))

    more = circle(4, 1.1)[3:]
    ntrace, discard, uw = spiral_model.update(
        3, gtrace, (4, torch.zeros(2)), ArgDiff.EXTEND, more)
    assert len(ntrace.data) == 4 and ntrace.args[0] == 4
    assert len(discard) == 1 and discard[0].is_empty()
    assert np.isfinite(float(uw))
    assert torch.equal(ntrace.data[0].read("obs"), gtrace.data[0].read("obs"))
    with pytest.raises(ValueError, match="ArgDiff"):
        spiral_model.update(3, gtrace, (4, torch.zeros(2)),
                            ArgDiff.NO_CHANGE, more)


def test_unfold_update_extend_hand_computed_weights():
    """Multi-step extension with fully / partly / un-constrained steps:
    per-step generate weights, empty discards, logjp accumulation and
    state threading."""

    @gen
    def rw_kernel(h, t, state):
        x = h.sample(normal, (state, 1.0), "x")
        h.sample(normal, (x, 0.5), "y")
        return x

    model = Unfold(rw_kernel)

    def logn(v, mu, sd):
        return float(normal.logpdf(torch.tensor(v), (torch.tensor(mu), sd)))

    obs = []
    for y in (0.3, -0.1):
        c = Trie()
        c.observe("y", y)
        obs.append(c)
    trace, w0 = model.generate(5, (2, 0.25), obs, device=CPU)
    x0 = float(trace.data[0].read("x"))
    x1 = float(trace.data[1].read("x"))
    np.testing.assert_allclose(
        float(w0), logn(0.3, x0, 0.5) + logn(-0.1, x1, 0.5), rtol=1e-12)

    c2 = Trie()
    c2.observe("x", 0.9)
    c2.observe("y", 1.1)
    c3 = Trie()
    c3.observe("y", -0.4)
    c4 = Trie()
    ntrace, discard, uw = model.update(6, trace, (5, 0.25), ArgDiff.EXTEND,
                                       [c2, c3, c4], device=CPU)
    assert ntrace.args[0] == 5
    assert len(ntrace.data) == 5 and len(ntrace.retv) == 5
    assert float(ntrace.retv[1]) == x1
    assert float(ntrace.data[0].read("x")) == x0
    assert len(discard) == 3 and all(d.is_empty() for d in discard)
    assert float(ntrace.retv[2]) == 0.9
    x3 = float(ntrace.data[3].read("x"))
    x4 = float(ntrace.data[4].read("x"))
    y4 = float(ntrace.data[4].read("y"))
    w2 = logn(0.9, x1, 1.0) + logn(1.1, 0.9, 0.5)
    w3 = logn(-0.4, x3, 0.5)
    np.testing.assert_allclose(float(uw), w2 + w3, rtol=1e-12)
    dlogjp = (w2 + logn(x3, 0.9, 1.0) + logn(-0.4, x3, 0.5)
              + logn(x4, x3, 1.0) + logn(y4, x4, 0.5))
    np.testing.assert_allclose(float(ntrace.logjp) - float(trace.logjp),
                               dlogjp, rtol=1e-10)
    # step t draws from fold_in(key, t): the same key, the same steps
    again, _, _ = model.update(6, trace, (5, 0.25), ArgDiff.EXTEND,
                               [c2, c3, c4], device=CPU)
    assert float(again.data[4].read("x")) == x4


def test_trace_copy():
    """A copy's data can be edited apart from the original's."""
    tr = Trace((1,), Trie.from_dict({"a": 1.0}), None, 0.0)
    cp = tr.copy()
    cp.data.observe("b", 2.0)
    assert "b" not in tr.data and cp.data["a"] == 1.0
    lst = Trace((1,), [Trie()], None, 0.0)
    lcp = lst.copy()
    lcp.data.append(Trie())
    assert len(lst.data) == 1 and lcp.data[0] is lst.data[0]


def _hmm():
    return HMM(HMMParams(torch.tensor(PRIOR), torch.tensor(EMISSION),
                         torch.tensor(TRANSITION)))


def test_hmm_genfn_contract():
    model = _hmm()
    tr, w = model.generate(0, (1, None), ([None], [2]))
    assert tr.args == (1, None) and len(tr.data[0]) == 1
    z = int(tr.data[0][0])
    assert float(w) == pytest.approx(math.log(EMISSION[2, z]), abs=1e-15)
    tr2, discard, w2 = model.update(1, tr, (2, None), ArgDiff.EXTEND,
                                    ([None, None], [2, 0]))
    z2 = int(tr2.data[0][1])
    assert tr2.args[0] == 2 and discard == ([], [])
    assert float(w2) == pytest.approx(math.log(EMISSION[0, z2]), abs=1e-15)
    assert float(tr2.logjp) == pytest.approx(float(w) + float(w2), abs=1e-15)
    with pytest.raises(ValueError, match="T = 1"):
        model.generate(0, (2, None), ([None], [2]))
    with pytest.raises(ValueError, match="ArgDiff"):
        model.update(1, tr, (2, None), ArgDiff.UNKNOWN, ([None], [0]))


def test_particle_filter_lml_vs_forward():
    num_particles, data = 300, [0, 0, 1, 2]
    expected = math.log(float(hmm_forward_alg(PRIOR, EMISSION, TRANSITION,
                                              data)))
    pf = ParticleSystem(_hmm(), num_particles, 0, device=CPU)
    pf.init_step(None, ([None], [data[0]]))
    for obs in data[1:]:
        pf.step(([None], [obs]))
        ess = float(pf.effective_sample_size())
        assert 0.0 < ess <= num_particles
        pf.resample()
    lml = float(pf.log_marginal_likelihood_estimate())
    assert lml == pytest.approx(expected, abs=0.25)


def test_smc_spiral_tracking():
    num_timesteps, num_particles = 12, 100
    data = circle(num_timesteps, 2.4)
    pf = ParticleSystem(spiral_model, num_particles, 5, device=CPU)
    pf.init_step(torch.zeros(2), [data[0]])
    pf.resample()
    for constraints in data[1:]:
        pf.step([constraints])
        pf.resample()
    final_obs = data[-1].read("obs")
    positions = torch.stack([polar_to_cartesian(tr.retv[-1])
                             for tr in pf.traces])
    assert float(torch.linalg.norm(positions.mean(0) - final_obs)) < 0.2
    assert np.isfinite(float(pf.log_marginal_likelihood_estimate()))
    assert all(len(tr.data) == num_timesteps for tr in pf.traces)


def test_resample_copies_the_parents():
    """After a resample every particle is a copy of a parent: a later
    step extends each copy on its own."""
    pf = ParticleSystem(spiral_model, 8, 1, device=CPU)
    data = circle(3, 0.2)
    pf.init_step(torch.zeros(2), [data[0]])
    pf.resample()
    assert torch.equal(pf.log_weights, torch.zeros(8))
    pf.step([data[1]])
    assert len({id(tr.data) for tr in pf.traces}) == 8
    assert all(len(tr.data) == 2 for tr in pf.traces)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParticleSystem(_hmm(), 10, 0)


# ---- parity with the JAX package on the same inputs --------------------


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got)),
                               np.asarray(want), **tol)


def _hold_trie(got, want):
    assert got.addresses() == want.addresses()
    for a in want.addresses():
        _close(got.read(a), want.read(a))


def _hold_unfold_trace(got, want):
    assert got.args[0] == want.args[0] and len(got.data) == len(want.data)
    for g, w in zip(got.data, want.data):
        _hold_trie(g, w)
    for g, w in zip(got.retv, want.retv):
        _close(g, w)
    _close(got.logjp, want.logjp)


def _spiral_steps(rng, t0, t1, pol):
    """Fully constrained spiral steps t0 .. t1 - 1 from the polar state
    ``pol``: every choice given (``r``, ``theta`` at t = 0, else ``dr``,
    ``dtheta``) with an observation near the point, as numpy dicts."""
    steps = []
    for t in range(t0, t1):
        if t == 0:
            c = {"r": rng.uniform(0.2, 0.8), "theta": rng.uniform(0, 6.2)}
            pol = np.array([c["r"], c["theta"]])
        else:
            c = {"dr": rng.normal(0.0, 0.1), "dtheta": rng.normal(0.4, 0.2)}
            pol = pol + np.array([c["dr"], c["dtheta"]])
        point = pol[0] * np.array([np.cos(pol[1]), np.sin(pol[1])])
        c["obs"] = point + rng.normal(0.0, 0.03, 2)
        steps.append(c)
    return steps


def _tries(steps, lib):
    out = []
    for c in steps:
        t = JTrie() if lib == "jax" else Trie()
        for a, v in c.items():
            t.observe(a, jnp.asarray(v) if lib == "jax"
                      else torch.as_tensor(v, dtype=torch.float64))
        out.append(t)
    return out


def _obs_only(steps):
    return [{"obs": c["obs"]} for c in steps]


def test_unfold_generate_update_match_reference():
    """Fully constrained steps leave no draw: the port's Unfold.generate
    from t = 0 and its EXTEND update of the reference's trace give the
    reference's weights, log-joints, states and choices."""
    rng = np.random.default_rng(11)
    steps = _spiral_steps(rng, 0, 3, None)
    j_tr, j_w = j_spiral_model.generate(
        jax.random.PRNGKey(0), (3, jnp.zeros(2)), _tries(steps, "jax"))
    tr, w = spiral_model.generate(0, (3, torch.zeros(2)),
                                  _tries(steps, "torch"), device=CPU)
    _close(w, j_w)
    _hold_unfold_trace(tr, j_tr)

    # the reference's trace with random latents (only the points given),
    # extended by two fully constrained steps on both sides
    obs = _obs_only(_spiral_steps(rng, 0, 3, None))
    j_tr, _ = j_spiral_model.generate(
        jax.random.PRNGKey(1), (3, jnp.zeros(2)), _tries(obs, "jax"))
    more = _spiral_steps(rng, 3, 5, np.asarray(j_tr.retv[-1]))
    j_new, j_discard, j_uw = j_spiral_model.update(
        jax.random.PRNGKey(2), j_tr, (5, jnp.zeros(2)), JArgDiff.EXTEND,
        _tries(more, "jax"))
    new, discard, uw = spiral_model.update(
        3, trace_from_reference(j_tr), (5, torch.zeros(2)), ArgDiff.EXTEND,
        _tries(more, "torch"), device=CPU)
    _close(uw, j_uw)
    _hold_unfold_trace(new, j_new)
    assert len(discard) == len(j_discard) == 2
    assert all(d.is_empty() for d in discard)


def _hmm_params():
    return (JHMMParams(np.array(PRIOR), EMISSION, TRANSITION),
            HMMParams(torch.tensor(PRIOR), torch.tensor(EMISSION),
                      torch.tensor(TRANSITION)))


def _matching_draw(call, state):
    """The port's result of ``call(key)`` for the first key whose new
    state is ``state`` (K = 3: a few keys suffice)."""
    for key in range(256):
        out = call(key)
        if int(out[0].data[0][-1]) == state:
            return out
    raise AssertionError(f"no key drew state {state}")


def _hold_hmm_trace(got, want):
    assert got.args[0] == want.args[0]
    assert [int(s) for s in got.data[0]] == [int(s) for s in want.data[0]]
    assert [int(o) for o in got.data[1]] == [int(o) for o in want.data[1]]
    assert [int(o) for o in got.retv] == [int(o) for o in want.retv]
    _close(got.logjp, want.logjp)


def test_hmm_genfn_matches_reference():
    """The reference's HMM traces through the port's generate and EXTEND
    updates, with the port's new state matched to the reference's: the
    same weights, log-joints, states and observations."""
    j_params, params = _hmm_params()
    j_model, model = JHMM(j_params), HMM(params)
    data = [0, 0, 1, 2, 2, 1]
    key = jax.random.PRNGKey(3)
    j_tr, j_w = j_model.generate(key, (1, None), ([None], [data[0]]))
    tr, w = _matching_draw(
        lambda k: model.generate(k, (1, None), ([None], [data[0]])),
        int(j_tr.data[0][-1]))
    _close(w, j_w)
    _hold_hmm_trace(tr, j_tr)
    for t in range(1, len(data)):
        key, k = jax.random.split(key)
        cons = ([None] * (t + 1), data[:t + 1])
        j_new, j_discard, j_w = j_model.update(
            k, j_tr, (t + 1, None), JArgDiff.EXTEND, cons)
        prev = trace_from_reference(j_tr)
        new, discard, w = _matching_draw(
            lambda kk: model.update(kk, prev, (t + 1, None), ArgDiff.EXTEND,
                                    cons),
            int(j_new.data[0][-1]))
        _close(w, j_w)
        _hold_hmm_trace(new, j_new)
        assert discard == j_discard == ([], [])
        j_tr = j_new


def _port_particles(j_pf):
    return [trace_from_reference(t) for t in j_pf.traces]


def test_particle_system_matches_reference():
    """ParticleSystem on the reference's particles: the port steps the
    reference's traces under fully constrained spiral steps (no draws)
    and gives its log-weights, ESS, each resample's log total weight and
    log-ML update, and the log-ML estimate. After each resample the port
    takes the reference's resampled particles (the parents are draws)."""
    n, rng = 40, np.random.default_rng(13)
    obs0 = _obs_only(_spiral_steps(rng, 0, 1, None))
    j_pf = JParticleSystem(j_spiral_model, n, jax.random.PRNGKey(4))
    j_pf.init_step(jnp.zeros(2), _tries(obs0, "jax"))
    pf = ParticleSystem(spiral_model, n, 0, device=CPU)
    pf.traces = _port_particles(j_pf)
    pf.log_weights = torch.as_tensor(np.array(j_pf.log_weights))
    pol = np.asarray(j_pf.traces[0].retv[-1])
    for t in range(1, 6):
        (step,) = _spiral_steps(rng, t, t + 1, pol)
        pol = pol + np.array([step["dr"], step["dtheta"]])
        j_pf.step(_tries([step], "jax"))
        pf.step(_tries([step], "torch"))
        _close(pf.log_weights, j_pf.log_weights, PF_TOL)
        _close(pf.effective_sample_size(), j_pf.effective_sample_size(),
               PF_TOL)
        _close(pf.log_marginal_likelihood_estimate(),
               j_pf.log_marginal_likelihood_estimate(), PF_TOL)
        for a, b in zip(pf.traces, j_pf.traces):
            _hold_unfold_trace(a, b)
        if t % 2:
            _close(pf.resample(), j_pf.resample(), PF_TOL)
            _close(pf.log_ml_estimate, j_pf.log_ml_estimate, PF_TOL)
            assert torch.equal(pf.log_weights, torch.zeros(n))
            pf.traces = _port_particles(j_pf)
    _close(pf.log_marginal_likelihood_estimate(),
           j_pf.log_marginal_likelihood_estimate(), PF_TOL)


def test_unfold_step_key_is_fold_in():
    """Step t of generate, and of an EXTEND update from prev_t, draws from
    ``fold_in(key, t)``: the kernel run by hand with those keys gives the
    same choices bitwise."""
    key, state = 9, torch.zeros(2)
    tr, _ = spiral_model.generate(key, (3, state), [Trie()] * 3, device=CPU)
    for t in range(3):
        sub, _ = spiral_kernel.generate(fold_in(key, t), (t, state), Trie(),
                                        device=CPU)
        for a in sub.data.addresses():
            assert torch.equal(tr.data[t].read(a), sub.data.read(a))
        state = sub.retv
    new, _, _ = spiral_model.update(key + 1, tr, (5, torch.zeros(2)),
                                    ArgDiff.EXTEND, [Trie()] * 2, device=CPU)
    for t in (3, 4):
        sub, _ = spiral_kernel.generate(fold_in(key + 1, t), (t, state),
                                        Trie(), device=CPU)
        for a in sub.data.addresses():
            assert torch.equal(new.data[t].read(a), sub.data.read(a))
        state = sub.retv


def test_resample_follows_the_weights():
    """4000 particles in 8 groups of log-weight ln(g + 1): the resampled
    parents' group counts against the multinomial's expectation (a
    chi-square of 7 degrees of freedom below its 0.001 quantile, 24.32),
    each parent a copy of the particle it names, and the same key giving
    the same parents."""
    n = 4000
    groups = torch.arange(n) % 8
    weights = (groups + 1).double()

    def parents(key):
        pf = ParticleSystem(spiral_model, n, key, device=CPU)
        pf.traces = [Trace((1, None), [Trie()], i, 0.0) for i in range(n)]
        pf.log_weights = torch.log(weights)
        pf.resample()
        return torch.tensor([tr.retv for tr in pf.traces])

    got = parents(21)
    counts = torch.bincount(groups[got], minlength=8).double()
    expected = n * torch.arange(1, 9).double() / 36.0
    assert float(((counts - expected) ** 2 / expected).sum()) < 24.32
    assert torch.equal(got, parents(21))
    assert not torch.equal(got, parents(22))
