"""Lane draws of every distribution (``Distribution.sample_lanes``), on the
CPU: the inversion forms, the rejection forms (core/keys.rejection_lanes)
and the CDF searches (dists/base.cdf_search).

Each lane form keeps the lane streams' rule: a lane's draw is bitwise its
1-lane draw and the first C lanes of a 2C draw are the C draw. The
reference's law gates (tests/test_dists.py:113-158,
tests/test_dists_extra.py:24-80, 50,000 draws each) hold on the lane draws.
The reference draws with ``jax.random.gamma`` / ``beta`` / ``poisson`` /
``binomial``, whose streams differ from the port's, so the two are held
to the same laws, not to the same values.
"""

import math

import numpy as np
import pytest
import scipy.stats as st
import torch

from modppl_tpu_torch.core import keys as K
from modppl_tpu_torch.core.keys import lanes, record_rejection, split_keys
from modppl_tpu_torch.dists import (
    beta,
    binomial,
    dirichlet,
    exponential,
    gamma,
    geometric,
    iid,
    laplace,
    mvnormal,
    negative_binomial,
    normal,
    plate,
    poisson,
    student_t,
    uniform_discrete,
)
from modppl_tpu_torch.dists import base as B
from _torch_threads import one_thread  # noqa: F401

N = 50_000
F64 = torch.float64

CASES = {
    "uniform_discrete": (uniform_discrete, (-3, 7)),
    "geometric": (geometric, (0.25,)),
    "poisson_search": (poisson, (4.0,)),
    "poisson_ptrs": (poisson, (36.11,)),
    "gamma": (gamma, (4.5, 2.0)),
    "gamma_boost": (gamma, (0.3, 1.5)),
    "beta": (beta, (2.0, 5.0)),
    "exponential": (exponential, (2.0,)),
    "laplace": (laplace, (1.0, 2.0)),
    "student_t": (student_t, (7.0, 0.5, 1.5)),
    "binomial_search": (binomial, (10, 0.4)),
    "binomial_btrs": (binomial, (100, 0.7)),
    "dirichlet": (dirichlet, (torch.tensor([2.0, 3.0, 5.0]),)),
    "negative_binomial": (negative_binomial, (3.0, 0.6)),
    "plate_gamma": (plate(gamma, 4), (2.0, 1.0)),
    "iid_gamma": (iid(gamma, 3), (2.0, 1.0)),
    "iid_mvnormal": (iid(mvnormal, 3),
                     (torch.tensor([0.0, 1.0]), ((1.0, 0.5), (0.5, 2.0)))),
    "iid_poisson_rates": (iid(poisson, 4),
                          (torch.tensor([0.5, 3.0, 12.0, 40.0]),)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_lane_is_its_one_lane_draw_whatever_the_lane_count(case):
    dist, params = CASES[case]
    x = dist.sample_lanes(split_keys(4, 37, "cpu"), params)
    wide = dist.sample_lanes(split_keys(4, 74, "cpu"), params)
    torch.testing.assert_close(wide[:37], x, rtol=0, atol=0)
    for i in (0, 11, 36):
        one = dist.sample_lanes(split_keys(4, 37, "cpu")[i:i + 1], params)
        torch.testing.assert_close(one[0], x[i], rtol=0, atol=0)


def _draws(dist, params, n=N, seed=0):
    return dist.sample_lanes(lanes(seed, n, "cpu"), params).double().numpy()


def test_reference_gates_scalar():
    """tests/test_dists.py:113-158's 50,000-draw gates."""
    assert _draws(geometric, (0.25,)).mean() == pytest.approx(3.0, abs=0.1)
    assert _draws(poisson, (4.0,)).mean() == pytest.approx(4.0, abs=0.05)
    assert _draws(beta, (2.0, 5.0)).mean() == pytest.approx(2.0 / 7.0,
                                                            abs=0.01)
    assert _draws(gamma, (4.5, 2.0)).mean() == pytest.approx(9.0, abs=0.1)


def test_reference_gates_extra():
    """tests/test_dists_extra.py:24-80's 50,000-draw gates."""
    xs = _draws(exponential, (2.0,))
    assert xs.mean() == pytest.approx(0.5, abs=0.02) and xs.min() >= 0.0
    xs = _draws(laplace, (1.0, 2.0))
    assert xs.mean() == pytest.approx(1.0, abs=0.05)
    assert xs.std() == pytest.approx(np.sqrt(2) * 2.0, abs=0.1)
    xs = _draws(student_t, (7.0, 0.5, 1.5))
    assert xs.mean() == pytest.approx(0.5, abs=0.05)
    assert xs.var() == pytest.approx(1.5 ** 2 * 7.0 / 5.0, rel=0.1)
    ks = _draws(binomial, (10, 0.4))
    assert ks.mean() == pytest.approx(4.0, abs=0.05)
    assert ks.min() >= 0 and ks.max() <= 10
    xs = _draws(dirichlet, (torch.tensor([2.0, 3.0, 5.0]),))
    assert xs.shape == (N, 3)
    np.testing.assert_allclose(xs.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(xs.mean(axis=0), [0.2, 0.3, 0.5], atol=0.01)
    ks = _draws(negative_binomial, (3.0, 0.6))
    assert ks.mean() == pytest.approx(3.0 * 0.4 / 0.6, abs=0.05)


@pytest.mark.parametrize("case,law", [
    ("gamma", st.gamma(4.5, scale=2.0)),
    ("gamma_boost", st.gamma(0.3, scale=1.5)),
    ("beta", st.beta(2.0, 5.0)),
    ("exponential", st.expon(scale=0.5)),
    ("laplace", st.laplace(1.0, 2.0)),
    ("student_t", st.t(7.0, 0.5, 1.5))])
def test_continuous_laws_by_kolmogorov_smirnov(case, law):
    """The KS distance of N lane draws to the closed-form CDF below its
    0.001 critical value 1.95 / sqrt(N)."""
    dist, params = CASES[case]
    x = _draws(dist, params, seed=1)
    assert st.kstest(x, law.cdf).statistic < 1.95 / math.sqrt(N)


@pytest.mark.parametrize("case,law", [
    ("uniform_discrete", st.randint(-3, 8)),
    ("geometric", st.geom(0.25, loc=-1)),
    ("poisson_search", st.poisson(4.0)),
    ("poisson_ptrs", st.poisson(36.11)),
    ("binomial_search", st.binom(10, 0.4)),
    ("binomial_btrs", st.binom(100, 0.7)),
    ("negative_binomial", st.nbinom(3, 0.6))])
def test_discrete_laws_by_chi_square(case, law):
    """Chi-square over the bins of expected count >= 5 (the tails pooled
    into the end bins) below its 0.001 quantile."""
    dist, params = CASES[case]
    k = _draws(dist, params, seed=2).astype(np.int64)
    support = np.arange(int(law.ppf(1e-9)) - 1, int(law.ppf(1 - 1e-9)) + 2)
    keep = support[N * law.pmf(support) >= 5]
    lo, hi = keep[0], keep[-1]
    obs = np.bincount(np.clip(k, lo, hi) - lo, minlength=hi - lo + 1)
    exp = N * law.pmf(np.arange(lo, hi + 1))
    exp[0] += N * law.cdf(lo - 1)
    exp[-1] += N * law.sf(hi)
    chi2 = float(np.sum((obs - exp) ** 2 / exp))
    assert chi2 < st.chi2.ppf(0.999, obs.size - 1)


def test_dirichlet_marginals_are_betas():
    x = _draws(dirichlet, (torch.tensor([2.0, 3.0, 5.0]),), seed=3)
    for i, a in enumerate((2.0, 3.0, 5.0)):
        law = st.beta(a, 10.0 - a)
        assert st.kstest(x[:, i], law.cdf).statistic < 1.95 / math.sqrt(N)


def test_iid_mvnormal_marginals_and_parameters():
    x = _draws(*CASES["iid_mvnormal"], seed=4)
    assert x.shape == (N, 3, 2)
    for j, law in enumerate((st.norm(0.0, 1.0), st.norm(1.0, math.sqrt(2)))):
        assert st.kstest(x[:, :, j].reshape(-1), law.cdf).statistic < \
            1.95 / math.sqrt(3 * N)
    cov = np.cov(x.reshape(-1, 2).T)
    np.testing.assert_allclose(cov, [[1.0, 0.5], [0.5, 2.0]], atol=0.03)
    ks = lanes(5, 6, "cpu")
    cov2 = ((1.0, 0.0), (0.0, 1.0))
    d = iid(mvnormal, 3)
    # per element (n, k), per lane and element (C, n, k), shared
    per_el = torch.arange(6, dtype=F64).reshape(3, 2)
    z = d.sample_lanes(ks, (torch.zeros(2, dtype=F64), cov2))
    torch.testing.assert_close(d.sample_lanes(ks, (per_el, cov2)),
                               z + per_el, rtol=0, atol=1e-15)
    per_lane = torch.arange(36, dtype=F64).reshape(6, 3, 2)
    torch.testing.assert_close(d.sample_lanes(ks, (per_lane, cov2)),
                               z + per_lane, rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="batch axes"):
        d.sample_lanes(ks, (torch.zeros(6, 2, dtype=F64), cov2))


def test_block_is_one_plate_a_key():
    """``block`` > 1: key i's stream gives lanes [i b, (i + 1) b) as one
    (b,) plate, the words ``iid(base, b)`` draws for lane i."""
    ks = lanes(6, 5, "cpu")
    for dist, params in ((gamma, (2.0, 1.0)), (poisson, (30.0,)),
                         (geometric, (0.3,))):
        blocked = dist.sample_lanes(ks, params, block=4)
        assert blocked.shape == (20,)
        torch.testing.assert_close(
            blocked.reshape(5, 4), iid(dist, 4).sample_lanes(ks, params),
            rtol=0, atol=0)


def test_uniform_discrete_reaches_both_ends_of_a_wide_range():
    """Rejection on the 63-bit word: every value of a range reachable,
    exactly uniform; a float32 floor(u m) could not reach past 2^24
    values. The ends of a 2^40-wide range are reached within 2^-12 of
    the width, and a word at the ends of the accepted run gives a and b."""
    a, b = -(1 << 39), (1 << 39) - 1
    x = uniform_discrete.sample_lanes(lanes(7, N, "cpu"), (a, b))
    assert x.dtype == torch.int64
    width = b - a + 1
    assert int(x.min()) - a < width >> 12 and b - int(x.max()) < width >> 12
    assert int(x.min()) >= a and int(x.max()) <= b
    assert len(set(x.tolist())) > N - 5
    small = uniform_discrete.sample_lanes(lanes(8, N, "cpu"), (0, 1))
    assert set(small.tolist()) == {0, 1}
    assert abs(float(small.double().mean()) - 0.5) < 0.01


def test_rounds_are_recorded_and_the_cap_raises():
    """Marsaglia-Tsang accepts at >= 0.95 a round: at 50,000 lanes the mean
    is near 1 and the most a handful, far below MAX_ROUNDS; one host read
    after the unrolled rounds. A draw still open at its cap raises, as
    does a CDF search past MAX_SEARCH_STEPS."""
    with record_rejection() as rec:
        gamma.sample_lanes(lanes(9, N, "cpu"), (2.0, 1.0))
    assert 1.0 < rec.mean_rounds < 1.05
    assert 2 <= rec.max_rounds <= 12 < K.MAX_ROUNDS
    assert rec.reads >= 1 and rec.elements == N

    def coin(bits):
        return bits[..., 0], (bits[..., 0] & 1) == 0

    out = K.rejection_lanes(lanes(1, 100, "cpu"), 3, 1, coin)
    assert out.shape == (100, 3) and bool(((out & 1) == 0).all())
    with pytest.raises(RuntimeError, match="not accepted in 2 rounds"):
        K.rejection_lanes(lanes(1, 1000, "cpu"), 1, 1, coin, unrolled=1,
                          max_rounds=2)
    u = torch.full((4,), 0.999, dtype=F64)
    with pytest.raises(RuntimeError, match="open after"):
        # a pmf that never moves the CDF far enough, without its stop
        B.cdf_search(u, torch.full_like(u, 1e-6), torch.ones_like)


def test_poisson_rates_per_element_take_both_arms():
    """Rates below and above the switch in one draw: each element keeps
    its arm's value; per-lane rates broadcast."""
    rates = torch.tensor([0.5, 3.0, 12.0, 40.0], dtype=F64).repeat(N // 4)
    k = poisson.sample_lanes(lanes(10, N, "cpu"), (rates,)).double()
    for j, r in enumerate((0.5, 3.0, 12.0, 40.0)):
        assert float(k[j::4].mean()) == pytest.approx(r, abs=5 * math.sqrt(
            r / (N / 4)))
    assert poisson.sample_lanes(lanes(10, 3, "cpu"), (0.0,)).tolist() == \
        [0, 0, 0]


def test_a_model_with_gamma_and_extra_sites_runs_over_lanes():
    """tests/test_dists_extra.py:81-98's exponential / laplace model and
    the gamma-prior scale model, each run once over C lane keys: lane i
    is the model run on lane i's key alone."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.modeling import gen

    one_ = torch.tensor(1.0, dtype=F64)

    @gen
    def model(h):
        rate = h.sample(exponential, (one_,), "rate")
        h.sample(laplace, (0.0, 1.0 / rate), "x")
        s = h.sample(gamma, (2.0 * one_, one_), "scale")
        h.sample(iid(normal, 5), (0.0, s), "ys")

    obs = Trie.from_dict({"x": torch.tensor(0.5, dtype=F64),
                          "ys": torch.tensor([0.5, -1.2, 0.8, 2.0, -0.3],
                                             dtype=F64)})
    ks = split_keys(3, 9, "cpu")
    tr, w = model.generate(ks, (), obs, device="cpu")
    assert w.shape == (9,) and bool(torch.isfinite(w).all())
    assert bool((tr.data["rate"] > 0).all() and (tr.data["scale"] > 0).all())
    one, w1 = model.generate(ks[4:5], (), obs, device="cpu")
    for a in ("rate", "scale"):
        torch.testing.assert_close(one.data[a][0], tr.data[a][4], rtol=0,
                                   atol=0)
    torch.testing.assert_close(w1[0], w[4], rtol=0, atol=0)
