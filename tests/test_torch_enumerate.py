"""Exact enumeration, port vs reference (CPU, float64).

``tests/test_enumerate.py``'s models run through both packages on the same
supports and observations: the log joints, log-evidence, posteriors and
marginals agree at 1e-12, and the reference's hand-computed gates run on
the port beside them. The port's models carry float64 constants so both
sides compute in float64 (torch's default dtype is float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu import bernoulli as jbernoulli
from modppl_tpu import categorical as jcategorical
from modppl_tpu import gen as jgen
from modppl_tpu import normal as jnormal
from modppl_tpu.inference import enumerate as jenum
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import bernoulli, categorical, normal
from modppl_tpu_torch.inference import enumerate as tenum
from modppl_tpu_torch.inference.importance import importance_sampling
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64


def _f(x):
    return torch.tensor(x, dtype=F64)


@jgen
def jmixture(h):
    z = h.sample(jbernoulli, 0.3, "z")
    mu = jnp.where(z, 2.0, -1.0)
    h.sample(jnormal, (mu, 1.0), "x")
    return z


@gen
def mixture(h):
    z = h.sample(bernoulli, _f(0.3), "z")
    mu = torch.where(torch.as_tensor(z), _f(2.0), _f(-1.0))
    h.sample(normal, (mu, 1.0), "x")
    return z


@jgen
def jtwo_discrete(h):
    z = h.sample(jcategorical, (jnp.array([0.2, 0.5, 0.3]),), "z")
    w = h.sample(jbernoulli, 0.6, "w")
    rate = jnp.asarray(z, jnp.float64) + jnp.where(w, 2.0, 0.5)
    h.sample(jnormal, (rate, 1.0), "y")
    return rate


@gen
def two_discrete(h):
    z = h.sample(categorical, (_f([0.2, 0.5, 0.3]),), "z")
    w = h.sample(bernoulli, _f(0.6), "w")
    rate = z.to(F64) + torch.where(w, _f(2.0), _f(0.5))
    h.sample(normal, (rate, 1.0), "y")
    return rate


CASES = {
    "bernoulli_gate": (jmixture, mixture, {"x": 1.0},
                       {"z": [False, True]}),
    "two_addresses": (jtwo_discrete, two_discrete, {"y": 2.5},
                      {"z": [0, 1, 2], "w": [False, True]}),
}


def _both(case):
    jmodel, tmodel, obs, sup = CASES[case]
    want = jenum.enumerate_posterior(
        jmodel, (), JTrie.from_dict(obs),
        {a: jnp.asarray(v) for a, v in sup.items()})
    got = tenum.enumerate_posterior(
        tmodel, (), Trie.from_dict(obs),
        {a: torch.tensor(v) for a, v in sup.items()}, device="cpu")
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_enumeration_matches_reference(case):
    got, want = _both(case)
    assert got["addrs"] == want["addrs"]
    for k in ("log_joint", "log_ml", "log_posterior"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    for a in want["addrs"]:
        np.testing.assert_allclose(got["marginals"][a].numpy(),
                                   np.asarray(want["marginals"][a]), **TOL)
        np.testing.assert_array_equal(got["grid"][a].numpy(),
                                      np.asarray(want["grid"][a]))


def test_bernoulli_gate_exact_posterior():
    got, _ = _both("bernoulli_gate")
    x = 1.0
    j0 = np.log(0.7) + st.norm(-1, 1).logpdf(x)
    j1 = np.log(0.3) + st.norm(2, 1).logpdf(x)
    log_ml = np.logaddexp(j0, j1)
    np.testing.assert_allclose(got["log_joint"].numpy(), [j0, j1], rtol=1e-9)
    assert float(got["log_ml"]) == pytest.approx(log_ml, abs=1e-9)
    assert float(got["marginals"]["z"][1]) == pytest.approx(
        np.exp(j1 - log_ml), abs=1e-9)


def test_joint_enumeration_two_addresses():
    got, _ = _both("two_addresses")
    assert got["log_joint"].shape == (6,)
    assert float(torch.sum(torch.exp(got["log_posterior"]))) == \
        pytest.approx(1.0, abs=1e-9)
    assert float(torch.sum(got["marginals"]["z"])) == pytest.approx(1.0,
                                                                    abs=1e-9)
    assert float(torch.sum(got["marginals"]["w"])) == pytest.approx(1.0,
                                                                    abs=1e-9)
    pz = [0.2, 0.5, 0.3]
    total = -np.inf
    for z in range(3):
        for wv in [0, 1]:
            rate = z + (2.0 if wv else 0.5)
            total = np.logaddexp(total, np.log(pz[z])
                                 + np.log(0.6 if wv else 0.4)
                                 + st.norm(rate, 1).logpdf(2.5))
    assert float(got["log_ml"]) == pytest.approx(total, abs=1e-9)


def test_auto_supports_bernoulli_only():
    obs = Trie.from_dict({"x": 0.5})
    sup = tenum.auto_supports(mixture, (), obs, device="cpu")
    assert set(sup) == {"z"}
    assert sup["z"].tolist() == [False, True]
    jsup = jenum.auto_supports(jmixture, (), JTrie.from_dict({"x": 0.5}))
    assert set(jsup) == set(sup)
    out = tenum.enumerate_posterior(mixture, (), obs, sup, device="cpu")
    assert float(torch.sum(torch.exp(out["log_posterior"]))) == \
        pytest.approx(1.0, abs=1e-9)
    with pytest.raises(ValueError, match="no inferable finite support"):
        tenum.auto_supports(two_discrete, (), Trie.from_dict({"y": 2.5}),
                            device="cpu")


def test_enumeration_matches_importance_sampling():
    obs = Trie.from_dict({"x": 1.0})
    exact = tenum.enumerate_posterior(mixture, (), obs,
                                      {"z": torch.tensor([False, True])},
                                      device="cpu")
    _, _, log_ml = importance_sampling(0, mixture, (), obs, 200_000,
                                       device="cpu")
    assert float(log_ml) == pytest.approx(float(exact["log_ml"]), abs=0.02)


def test_support_of_and_device(monkeypatch):
    from modppl_tpu_torch.dists import uniform_discrete

    assert tenum.support_of(bernoulli, 0.3, device="cpu").tolist() == \
        [False, True]
    assert tenum.support_of(uniform_discrete, (2, 5),
                            device="cpu").tolist() == [2, 3, 4, 5]
    assert tenum.support_of(categorical, (_f([0.5, 0.5]),),
                            device="cpu").tolist() == [0, 1]
    assert tenum.support_of(normal, (0.0, 1.0), device="cpu") is None
    assert np.asarray(jenum.support_of(jbernoulli, 0.3)).tolist() == \
        [False, True]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obs = Trie.from_dict({"x": 1.0})
    sup = {"z": torch.tensor([False, True])}
    for call in (lambda **kw: tenum.enumerate_posterior(mixture, (), obs, sup,
                                                        **kw),
                 lambda **kw: tenum.auto_supports(mixture, (), obs, **kw),
                 lambda **kw: tenum.support_of(bernoulli, 0.3, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    with pytest.raises(TypeError, match="not a @gen model"):
        tenum.enumerate_posterior(object(), (), obs, sup, device="cpu")
