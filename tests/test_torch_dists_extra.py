"""The port's extra distributions, its IID batch-axis rule and its large-K
categorical against the JAX package (CPU, float64).

The six log-densities of dists/extra.py and IID's log-density are held to
the reference's at 1e-12 on seeded numpy inputs; the samplers by their
moments (50 000 draws, the bounds of tests/test_dists_extra.py); the
categorical's large-K arm against a float64 inverse CDF on the same
uniforms, and its K <= 8 arm bitwise against the elementwise loop it has
always run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.dists import binomial as j_binomial
from modppl_tpu.dists import dirichlet as j_dirichlet
from modppl_tpu.dists import exponential as j_exponential
from modppl_tpu.dists import laplace as j_laplace
from modppl_tpu.dists import mvnormal as j_mvnormal
from modppl_tpu.dists import negative_binomial as j_negative_binomial
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.dists import student_t as j_student_t
from modppl_tpu.dists.iid import iid as j_iid
from modppl_tpu_torch.core import Trie
from modppl_tpu_torch.dists import (
    binomial,
    categorical,
    dirichlet,
    exponential,
    geometric,
    iid,
    laplace,
    mvnormal,
    negative_binomial,
    normal,
    student_t,
)
from modppl_tpu_torch.dists.scalar import SMALL_K
from modppl_tpu_torch.inference.hmc import latent_bijectors
from modppl_tpu_torch.inference.transforms import EXP
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=0.0, atol=1e-12)
N = 50_000


@pytest.fixture(autouse=True)
def float64_default():
    """The reference runs with x64: the port's default float follows."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def _inputs(name, rng, n=64):
    """(x, params) as numpy arrays for each distribution, in its support
    and beyond it."""
    if name == "exponential":
        return rng.standard_normal(n) + 0.5, (rng.uniform(0.2, 3.0, n),)
    if name == "laplace":
        return rng.standard_normal(n), (rng.standard_normal(n),
                                        rng.uniform(0.2, 3.0, n))
    if name == "student_t":
        return rng.standard_normal(n) * 2, (rng.uniform(0.5, 10.0, n),
                                            rng.standard_normal(n),
                                            rng.uniform(0.2, 3.0, n))
    if name == "binomial":
        nn = rng.integers(0, 20, n)
        return rng.integers(-2, 22, n), (nn, rng.uniform(0.0, 1.0, n))
    if name == "negative_binomial":
        return rng.integers(-1, 30, n), (rng.uniform(0.5, 8.0, n),
                                         rng.uniform(0.05, 1.0, n))
    alpha = rng.uniform(0.3, 5.0, (n, 4))
    x = rng.dirichlet(np.ones(4), n)
    return x, (alpha,)


PAIRS = {"exponential": (exponential, j_exponential),
         "laplace": (laplace, j_laplace),
         "student_t": (student_t, j_student_t),
         "binomial": (binomial, j_binomial),
         "dirichlet": (dirichlet, j_dirichlet),
         "negative_binomial": (negative_binomial, j_negative_binomial)}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_logpdf_matches_reference(name):
    port, ref = PAIRS[name]
    x, params = _inputs(name, np.random.default_rng(len(name)))
    got = port.logpdf(tensor(x), tuple(tensor(p) for p in params)).numpy()
    want = np.asarray(ref.logpdf(jnp.asarray(x),
                                 tuple(jnp.asarray(p) for p in params)))
    assert got.shape == want.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert finite.sum() > len(want) // 3
    np.testing.assert_allclose(got[finite], want[finite], **TOL)
    # host numbers as parameters, as a model writes them
    p0 = tuple(float(p[0]) if p.ndim == 1 else tensor(p[0]) for p in params)
    np.testing.assert_allclose(
        float(port.logpdf(tensor(x[0]), p0)),
        float(ref.logpdf(jnp.asarray(x[0]),
                         tuple(jnp.asarray(np.asarray(p[0]))
                               for p in params))), **TOL)


def test_support_metadata():
    assert exponential.support == "positive"
    assert laplace.support == student_t.support == "real"
    assert binomial.is_discrete and negative_binomial.is_discrete
    assert dirichlet.support == "other" and dirichlet.event_rank == 1


def test_binomial_negbinomial_boundary_p():
    """xlogy guards: exact 0-weight outcomes at p in {0, 1} score 0.0 or
    -inf, never NaN (tests/test_dists_extra.py:101)."""
    assert float(binomial.logpdf(0, (5, 0.0))) == 0.0
    assert float(binomial.logpdf(5, (5, 1.0))) == 0.0
    assert float(binomial.logpdf(3, (5, 0.0))) == -np.inf
    assert float(negative_binomial.logpdf(0, (3, 1.0))) == 0.0
    assert not np.isnan(float(negative_binomial.logpdf(2, (3, 1.0))))
    # r = 1 is the reference's geometric
    assert float(negative_binomial.logpdf(2, (1.0, 0.3))) == pytest.approx(
        float(geometric.logpdf(2, 0.3)), abs=1e-12)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_sampler_moments():
    xs = exponential.sample_batch(_gen(0), (N,), 2.0).numpy()
    assert xs.mean() == pytest.approx(0.5, abs=0.02) and xs.min() >= 0.0
    xs = laplace.sample_batch(_gen(1), (N,), (1.0, 2.0)).numpy()
    assert xs.mean() == pytest.approx(1.0, abs=0.05)
    assert xs.std() == pytest.approx(np.sqrt(2) * 2.0, abs=0.1)
    xs = student_t.sample_batch(_gen(2), (N,), (7.0, 0.5, 1.5)).numpy()
    assert xs.mean() == pytest.approx(0.5, abs=0.05)
    assert xs.var() == pytest.approx(1.5 ** 2 * 7.0 / 5.0, rel=0.1)
    ks = binomial.sample_batch(_gen(3), (N,), (10, 0.4))
    assert ks.dtype == torch.int32
    assert ks.double().mean() == pytest.approx(4.0, abs=0.05)
    assert int(ks.min()) >= 0 and int(ks.max()) <= 10
    alpha = torch.tensor([2.0, 3.0, 5.0])
    xs = dirichlet.sample_batch(_gen(4), (N,), (alpha,)).numpy()
    assert xs.shape == (N, 3)
    np.testing.assert_allclose(xs.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(xs.mean(axis=0), [0.2, 0.3, 0.5], atol=0.01)
    ks = negative_binomial.sample_batch(_gen(5), (N,), (3.0, 0.6))
    assert ks.dtype == torch.int32
    assert ks.double().mean() == pytest.approx(3.0 * 0.4 / 0.6, abs=0.05)
    # per-draw parameters broadcast
    lam = torch.tensor([0.5, 4.0])
    xs = exponential.sample_batch(_gen(6), (N, 2), lam)
    np.testing.assert_allclose(xs.mean(0).numpy(), [2.0, 0.25], rtol=0.03)


def test_extra_dists_in_gen_models():
    """The extensions compose with the DSL; ``exponential``'s support
    gives HMC the Exp bijector."""

    @gen
    def model(h):
        rate = h.sample(exponential, (1.0,), "rate")
        h.sample(laplace, (0.0, 1.0 / rate), "x")

    tr = model.simulate(1, (), device="cpu")
    assert float(tr.data.read("rate")) > 0.0
    obs = Trie.from_dict({"x": 0.5})
    tr2, w = model.generate(2, (), obs, device="cpu")
    assert np.isfinite(float(w))
    bij = latent_bijectors(tr2, obs)
    assert set(bij) == {"rate"} and bij["rate"] is EXP


# --------------------------------------------------------------------------
# IID: the plate axis is summed, a leading lane axis survives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shared", ["mean", "std", "none"])
def test_iid_normal_batch_axis_rule(shared):
    rng = np.random.default_rng(3)
    n = 7
    x = rng.standard_normal(n)
    mean = rng.standard_normal(n) if shared != "mean" else 0.3
    std = rng.uniform(0.5, 2.0, n) if shared != "std" else 0.8
    params = (mean, std)
    got = iid(normal, n).logpdf(tensor(x), tuple(
        tensor(p) if isinstance(p, np.ndarray) else p for p in params))
    want = j_iid(j_normal, n).logpdf(jnp.asarray(x), tuple(
        jnp.asarray(p) if isinstance(p, np.ndarray) else p for p in params))
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("cov_per_element", [False, True])
def test_iid_mvnormal_per_element(cov_per_element):
    """A non-scalar base: per-element means (n, k), a shared or
    per-element covariance; and draws of the right shape."""
    rng = np.random.default_rng(4)
    n, k = 5, 3
    a = rng.standard_normal((n, k, k))
    covs = a @ np.swapaxes(a, 1, 2) / k + np.eye(k)
    cov = covs if cov_per_element else covs[0]
    mu, x = rng.standard_normal((n, k)), rng.standard_normal((n, k))
    dist = iid(mvnormal, n)
    got = dist.logpdf(tensor(x), (tensor(mu), tensor(cov)))
    want = j_iid(j_mvnormal, n).logpdf(jnp.asarray(x), (jnp.asarray(mu),
                                                        jnp.asarray(cov)))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert not dist.batched((tensor(mu), tensor(cov)))
    draws = dist.sample(_gen(0), (tensor(mu), tensor(cov)))
    assert draws.shape == (n, k)
    # over 4 lanes: per-lane means (4, n, k) make the site batched
    lanes = tensor(rng.standard_normal((4, n, k)))
    assert dist.batched((lanes, tensor(cov)))
    assert dist.sample_batch(_gen(1), (4,), (tensor(mu), tensor(cov))
                             ).shape == (4, n, k)


def test_iid_over_lanes_keeps_the_lane_axis():
    """Under the batched tier x and the means are (lanes, n): the
    log-density is (lanes,), each lane the reference's scalar."""
    rng = np.random.default_rng(5)
    lanes, n = 6, 5
    x, mean = rng.standard_normal((lanes, n)), rng.standard_normal((lanes, n))
    dist = iid(normal, n)
    got = dist.logpdf(tensor(x), (tensor(mean), 0.1))
    assert got.shape == (lanes,)
    want = [float(j_iid(j_normal, n).logpdf(jnp.asarray(x[i]),
                                            (jnp.asarray(mean[i]), 0.1)))
            for i in range(lanes)]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert dist.batched((tensor(mean), 0.1))
    assert not dist.batched((tensor(mean[0]), 0.1))
    assert dist.sample_batch(_gen(2), (lanes,), (0.0, 1.0)).shape == (lanes, n)


# --------------------------------------------------------------------------
# categorical: the large-K arm and the K <= 8 arm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [9, 300, 5000])
def test_large_k_categorical_is_the_inverse_cdf(k):
    """The draws equal a float64 inverse CDF on the same uniforms (drawn
    from the same generator), in draw order; a zero-probability index is
    never drawn."""
    rng = np.random.default_rng(k)
    p = rng.uniform(0.0, 1.0, k) ** 3
    p[rng.integers(0, k, k // 4 + 1)] = 0.0
    p /= p.sum()
    draws = 20_000
    idx = categorical.sample_batch(_gen(k), (draws,), (tensor(p),))
    assert idx.dtype == torch.int32 and idx.shape == (draws,)
    u = torch.rand(draws, generator=_gen(k), dtype=torch.float64).numpy()
    cdf = np.cumsum(p)
    want = np.minimum(np.searchsorted(cdf, u * cdf[-1], side="right"), k - 1)
    assert np.array_equal(idx.numpy(), want)
    assert np.all(p[idx.numpy()] > 0.0)
    # the same key gives the same indices
    assert torch.equal(idx, categorical.sample_batch(_gen(k), (draws,),
                                                     (tensor(p),)))


def test_large_k_categorical_rows():
    """Per-row probability vectors (a batch of rows) take the same rule,
    one uniform a row."""
    rng = np.random.default_rng(9)
    p = rng.uniform(0.0, 1.0, (3, 40))
    idx = categorical.sample(_gen(3), (tensor(p),))
    u = torch.rand(3, generator=_gen(3), dtype=torch.float64).numpy()
    cdf = np.cumsum(p, 1)
    want = [min(int(np.searchsorted(cdf[i], u[i] * cdf[i, -1], "right")), 39)
            for i in range(3)]
    assert idx.tolist() == want
    # the rows broadcast against a batch of draws: draw (j, i) from row i
    idx = categorical.sample_batch(_gen(4), (2, 3), (tensor(p),))
    u = torch.rand((2, 3), generator=_gen(4), dtype=torch.float64).numpy()
    want = [[min(int(np.searchsorted(cdf[i], u[j, i] * cdf[i, -1], "right")),
                 39) for i in range(3)] for j in range(2)]
    assert idx.shape == (2, 3) and idx.tolist() == want
    # a single (1, K) row is searched by every draw
    idx = categorical.sample_batch(_gen(5), (7,), (tensor(p[:1]),))
    u = torch.rand(7, generator=_gen(5), dtype=torch.float64).numpy()
    want = np.minimum(np.searchsorted(cdf[0], u * cdf[0, -1], "right"), 39)
    assert idx.shape == (7,) and idx.tolist() == want.tolist()


def _loop_categorical(gen, batch, probs):
    """The K <= 8 arm as it has always been: running sums and one
    comparison a column."""
    cdf = [probs[..., 0]]
    for j in range(1, probs.shape[-1]):
        cdf.append(cdf[-1] + probs[..., j])
    u = torch.rand(batch, generator=gen, dtype=probs.dtype) * cdf[-1]
    idx = torch.zeros(batch, dtype=torch.int32)
    for c in cdf[:-1]:
        idx += c <= u
    return idx


@pytest.mark.parametrize("k", [3, SMALL_K])
def test_small_k_categorical_draws_unchanged(k):
    rng = np.random.default_rng(k)
    rows = tensor(rng.dirichlet(np.ones(k), 1000))
    got = categorical.sample(_gen(1), (rows,))
    assert torch.equal(got, _loop_categorical(_gen(1), (1000,), rows))
    one = tensor(rng.dirichlet(np.ones(k)))
    got = categorical.sample_batch(_gen(2), (500,), (one,))
    assert torch.equal(got, _loop_categorical(_gen(2), (500,), one))
