"""The port's Metropolis-Hastings against the JAX package's (CPU, float64).

One transition of each proposal kind on the reference's previous trace and
forward choices (the hierarchical drift, the trans-dimensional jump in both
directions, the hand-coded ``DriftProposal``): the update weight, the
discard, the forward and backward weights and the log acceptance ratio
equal the reference's at 1e-10. One regenerative transition the same way,
its draws the reference's through ``pool=``. Then the reference's chain
gates of tests/test_mh.py on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import ArgDiff as JArgDiff
from modppl_tpu import Trie as JTrie
from modppl_tpu import select as jselect
from modppl_tpu.models import Bounds as JBounds
from modppl_tpu.models import DriftProposal as JDriftProposal
from modppl_tpu.models import PointedModel as JPointedModel
from modppl_tpu.models import (
    add_or_remove_param_proposal as j_add_or_remove_param_proposal,
)
from modppl_tpu.models import (
    hierarchical_drift_proposal as j_hierarchical_drift_proposal,
)
from modppl_tpu.models import hierarchical_model as j_hierarchical_model
from modppl_tpu_torch.core import ArgDiff, Trie, select
from modppl_tpu_torch.core.keys import split
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.inference import mh, regen_mh
from modppl_tpu_torch.inference.mh import _mh_terms
from modppl_tpu_torch.interop import from_reference, trace_from_reference
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models import (
    Bounds,
    DriftProposal,
    PointedModel,
    add_or_remove_param_proposal,
    hierarchical_drift_proposal,
    hierarchical_model,
    read_coeffs,
)
from _torch_threads import one_thread  # noqa: F401

CPU = "cpu"
TOL = dict(rtol=0.0, atol=1e-10)
XS = [-2.0, -1.0, 0.0, 1.0, 2.0]
YS = [0.3 + 0.4 * x + 0.5 * x * x for x in XS]
COV = [[1.0, -0.6], [-0.6, 2.0]]
DRIFT = [[0.25, 0.0], [0.0, 0.25]]


@pytest.fixture(autouse=True)
def float64_default():
    """The reference runs with x64: the port's default float follows."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _obs(trie_cls, is_linear=None):
    obs = trie_cls()
    for i, y in enumerate(YS):
        obs.observe(f"(y, {i})", y)
    if is_linear is not None:
        obs.observe("is_linear", is_linear)
    return obs


def _close(got, want):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got)),
                               np.asarray(want), **TOL)


def _hold_discard(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                _close(g, w)
        return
    assert got.addresses() == want.addresses()
    for a in want.addresses():
        _close(torch.as_tensor(got.read(a)).double(),
               np.asarray(want.read(a), np.float64))
    _close(got.weight(), want.weight())


def _reference_terms(key, model, trace, proposal, args):
    """The reference's mh (inference/mh.py:25-43) step by step."""
    k_fwd, k_upd, k_bwd, _ = jax.random.split(key, 4)
    fwd, fwd_w = proposal.propose(k_fwd, (trace,) + args)
    new_trace, discard, weight = model.update(
        k_upd, trace, trace.args, JArgDiff.NO_CHANGE, fwd)
    bwd_w = proposal.assess(k_bwd, (new_trace,) + args, discard)
    return fwd, new_trace, discard, weight, fwd_w, bwd_w


def _hold_transition(key, j_model, j_trace, j_proposal, model, proposal,
                     args=()):
    fwd, j_new, j_discard, j_w, j_fwd, j_bwd = _reference_terms(
        key, j_model, j_trace, j_proposal, args)
    new, discard, w, fwd_w, bwd_w = _mh_terms(
        split(0, 4)[:3], model, trace_from_reference(j_trace), proposal,
        args, fwd_choices=from_reference(fwd))
    _close(w, j_w)
    _close(fwd_w, j_fwd)
    _close(bwd_w, j_bwd)
    _close(w - fwd_w + bwd_w, j_w - j_fwd + j_bwd)
    _close(new.logjp, j_new.logjp)
    _hold_discard(discard, j_discard)
    return fwd, new


@pytest.mark.parametrize("is_linear", [False, True])
def test_drift_transition_matches_reference(is_linear):
    j_trace, _ = j_hierarchical_model.generate(
        jax.random.PRNGKey(3), (XS,), _obs(JTrie, is_linear))
    _hold_transition(jax.random.PRNGKey(4), j_hierarchical_model, j_trace,
                     j_hierarchical_drift_proposal, hierarchical_model,
                     hierarchical_drift_proposal, (0.05,))


@pytest.mark.parametrize("from_linear", [True, False])
def test_transdimensional_transition_matches_reference(from_linear):
    """The jump in both directions: the reference's forward gate is the
    other branch's."""
    j_trace, _ = j_hierarchical_model.generate(
        jax.random.PRNGKey(5), (XS,), _obs(JTrie, from_linear))
    for seed in range(64):
        key = jax.random.PRNGKey(100 + seed)
        k_fwd = jax.random.split(key, 4)[0]
        fwd, _ = j_add_or_remove_param_proposal.propose(k_fwd, (j_trace,))
        if bool(fwd.read("is_linear")) != from_linear:
            break
    fwd, new = _hold_transition(
        key, j_hierarchical_model, j_trace, j_add_or_remove_param_proposal,
        hierarchical_model, add_or_remove_param_proposal)
    assert len(read_coeffs(new)) == (3 if from_linear else 2)


def test_pointed_drift_transition_matches_reference():
    jb = JBounds(-5.0, 5.0, -5.0, 5.0)
    j_model = JPointedModel(jnp.asarray(COV))
    j_trace, _ = j_model.generate(jax.random.PRNGKey(6), jb,
                                  (None, jnp.array([0.4, -0.3])))
    _hold_transition(jax.random.PRNGKey(7), j_model, j_trace,
                     JDriftProposal(jnp.asarray(DRIFT)),
                     PointedModel(torch.tensor(COV)),
                     DriftProposal(torch.tensor(DRIFT)))


@pytest.mark.parametrize("selection", [("coeffs",), ("is_linear", "coeffs")])
def test_regen_transition_matches_reference(selection):
    """regenerate over ``selection`` with the reference's new draws: the
    weight (the log acceptance ratio) and the new log-joint at 1e-10;
    ``regen_mh`` returns that trace or the old one."""
    j_trace, _ = j_hierarchical_model.generate(
        jax.random.PRNGKey(8), (XS,), _obs(JTrie, True))
    trace = trace_from_reference(j_trace)
    for seed in range(8):
        j_new, j_w = j_hierarchical_model.regenerate(
            jax.random.PRNGKey(200 + seed), j_trace, j_trace.args,
            JArgDiff.NO_CHANGE, jselect(*selection))
        pool = {a: from_reference(j_new.data.read(a))
                for a in j_new.data.addresses()
                if a.split(" / ")[0] in selection}
        new, w = hierarchical_model.regenerate(
            0, trace, trace.args, ArgDiff.NO_CHANGE, select(*selection),
            pool=pool)
        _close(w, j_w)
        _close(new.logjp, j_new.logjp)
        assert new.data.addresses() == j_new.data.addresses()
        out, accepted = regen_mh(seed, hierarchical_model, trace,
                                 select(*selection), pool=pool)
        assert out.data.addresses() == (new if accepted
                                        else trace).data.addresses()


def test_regen_of_the_gate_alone_raises_as_the_reference():
    """Regenerating only ``is_linear`` of a quadratic trace to True hands
    ``linear`` the quadratic's three coefficients: both sides raise."""
    j_trace, _ = j_hierarchical_model.generate(
        jax.random.PRNGKey(9), (XS,), _obs(JTrie, False))
    trace = trace_from_reference(j_trace)
    with pytest.raises(ValueError, match="not all constraints"):
        hierarchical_model.regenerate(0, trace, trace.args, ArgDiff.NO_CHANGE,
                                      select("is_linear"),
                                      pool={"is_linear": torch.tensor(True)})
    raised = 0
    for seed in range(6):
        try:
            j_hierarchical_model.regenerate(
                jax.random.PRNGKey(seed), j_trace, j_trace.args,
                JArgDiff.NO_CHANGE, jselect("is_linear"))
        except ValueError as e:
            raised += "not all constraints" in str(e)
    assert raised > 0


# --------------------------------------------------------------------------
# the reference's chain gates (tests/test_mh.py), on the port alone
# --------------------------------------------------------------------------

@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")
    return mu


@gen
def drift_proposal(h, trace, drift):
    h.sample(normal, (trace.data.read("mu"), drift), "mu")


def test_mh_conjugate_posterior():
    trace, _ = conjugate.generate(0, (), Trie.from_dict({"x": 1.0}),
                                  device=CPU)
    key, samples, n_accept = 1, [], 0
    for _ in range(3000):
        key, k = split(key)
        trace, accepted = mh(k, conjugate, trace, drift_proposal, (0.8,))
        n_accept += int(accepted)
        samples.append(float(trace.data.read("mu")))
    samples = np.array(samples[500:])
    assert 0.15 < n_accept / 3000 < 0.95
    assert samples.mean() == pytest.approx(0.5, abs=0.08)
    assert samples.std() == pytest.approx(np.sqrt(0.5), abs=0.08)


def test_regen_mh_conjugate_posterior():
    trace, _ = conjugate.generate(2, (), Trie.from_dict({"x": 1.0}),
                                  device=CPU)
    key, samples = 3, []
    for _ in range(4000):
        key, k = split(key)
        trace, _ = regen_mh(k, conjugate, trace, select("mu"))
        samples.append(float(trace.data.read("mu")))
    samples = np.array(samples[500:])
    assert samples.mean() == pytest.approx(0.5, abs=0.08)
    assert samples.std() == pytest.approx(np.sqrt(0.5), abs=0.08)


def test_mh_handcoded_pointed():
    model = PointedModel(torch.tensor(COV))
    proposal = DriftProposal(torch.tensor(DRIFT))
    trace, _ = model.generate(4, Bounds(-5.0, 5.0, -5.0, 5.0),
                              (None, torch.tensor([0.0, 0.0])))
    key, n_accept = 5, 0
    for _ in range(200):
        key, k = split(key)
        trace, accepted = mh(k, model, trace, proposal)
        n_accept += int(accepted)
    assert n_accept > 10
    assert bool(torch.isfinite(trace.data[0]).all())


def test_mh_hierarchical_transdimensional():
    trace, _ = hierarchical_model.generate(6, (XS,), _obs(Trie), device=CPU)
    key, all_coeffs = 7, []
    for _ in range(30):
        key, k = split(key)
        trace, _ = mh(k, hierarchical_model, trace,
                      add_or_remove_param_proposal)
        all_coeffs.append(read_coeffs(trace))
        for _ in range(3):
            key, k = split(key)
            trace, _ = mh(k, hierarchical_model, trace,
                          hierarchical_drift_proposal, (0.05,))
            all_coeffs.append(read_coeffs(trace))
    assert all(np.isfinite([float(v) for v in cs]).all() for cs in all_coeffs)
    # with strongly quadratic data the chain ends in the quadratic model
    assert len(read_coeffs(trace)) == 3
