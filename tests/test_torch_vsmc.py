"""The resampling schemes, kernel 4's plain version and the batched HMM
filter, port vs reference (CPU).

The reference runs as its own tests run it on a CPU: ``grid_rank`` and the
fused gather in interpret mode, the schemes in XLA. On CPU tensors the port's
kernel wrappers run their plain versions. The CDFs add in XLA's CPU order
(``utils/numerics.ordered_cumsum``), so on the reference's own uniforms the
ancestors are bitwise the reference's; the filter, whose random streams
differ (threefry vs Philox), is held to the reference's statistical gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.dists import categorical as j_categorical
from modppl_tpu.models import hmm as jhmm
from modppl_tpu.ops.fused_resample_pallas import (
    systematic_resample_fused as j_systematic_resample_fused,
)
from modppl_tpu.ops.resample_pallas import grid_rank as j_grid_rank
from modppl_tpu.parallel import resample as jres
from modppl_tpu_torch.core.address import select
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import categorical
from modppl_tpu_torch.inference.vsmc import batched_particle_filter
from modppl_tpu_torch.interop import hmm_params_from_numpy, tensor
from modppl_tpu_torch.models import hmm
from modppl_tpu_torch.models.spiral import (
    circle_observations,
    spiral_scan_kernel,
)
from modppl_tpu_torch.ops import fused_resample, resample
from modppl_tpu_torch.parallel import resample as tres
from modppl_tpu_torch.utils.numerics import ordered_cumsum
from _torch_threads import one_thread  # noqa: F401

N_RANK = 4096
# tests/test_vsmc.py:29-40: the reference's quantitative SMC gate
GATE_PRIOR = np.array([0.2, 0.3, 0.5])
GATE_EMISSION = np.array([[0.1, 0.2, 0.7], [0.2, 0.7, 0.1],
                          [0.7, 0.2, 0.1]]).T
GATE_TRANSITION = np.array([[0.4, 0.4, 0.2], [0.2, 0.3, 0.5],
                            [0.9, 0.05, 0.05]]).T
GATE_DATA = [0, 0, 1, 2]


def _case_lw(name, n, dtype=jnp.float64):
    """tests/test_resample_pallas.py:23-29's five weight cases, normalized."""
    if name == "normal":
        lw = jax.random.normal(jax.random.PRNGKey(0), (n,), dtype)
    elif name == "peaked":
        lw = jax.random.normal(jax.random.PRNGKey(1), (n,), dtype) * 5.0
    elif name == "uniform":
        lw = jnp.zeros((n,), dtype)
    elif name == "degenerate":
        lw = jnp.full((n,), -1e9, dtype).at[1234].set(0.0)
    else:
        lw = jnp.full((n,), -1e9, dtype).at[0].set(0.0).at[n - 1].set(0.0)
    return lw - jax.scipy.special.logsumexp(lw)


CASES = ["normal", "peaked", "uniform", "degenerate", "two-spikes"]


def _jax_s(lw, u):
    """The reference's sorted slot positions (systematic_parents_pallas)."""
    n = lw.shape[0]
    cdf = jres._normalized_cdf(lw)
    return jax.lax.cummax(jnp.clip(jnp.ceil(cdf * n - u), 0, n)
                          .astype(jnp.int32))


@pytest.mark.parametrize("name", CASES)
def test_grid_rank_plain_matches_reference_kernel(name):
    """On the same S: the plain version and the wrapper (CPU) equal the
    interpret-mode Pallas grid_rank, bitwise."""
    lw = _case_lw(name, N_RANK)
    s = _jax_s(lw, jax.random.uniform(jax.random.PRNGKey(3), (), lw.dtype))
    want = np.asarray(j_grid_rank(s, N_RANK, interpret=True))
    s_t = tensor(np.asarray(s))
    np.testing.assert_array_equal(resample.grid_rank_plain(s_t, N_RANK)
                                  .numpy(), want)
    np.testing.assert_array_equal(resample.grid_rank(s_t, N_RANK).numpy(),
                                  want)
    assert resample.grid_rank.launches == 0


def test_grid_rank_other_sizes():
    """Fewer input particles than slots (the clip) and an N that is not a
    multiple of 1024: the counting definition, checked directly."""
    s = np.sort(np.random.default_rng(0).integers(0, 1001, 700)).astype(
        np.int32)
    got = resample.grid_rank(tensor(s), 700, 1000).numpy()
    want = np.minimum([(s <= i).sum() for i in range(1000)], 699)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("name", CASES)
def test_systematic_parents_bitwise(name, dtype):
    """systematic_parents on the reference's uniform equals
    _grid_parents(_normalized_cdf(lw), u, n) bitwise; and it keeps the
    systematic properties (tests/test_resample_pallas.py:38-49)."""
    lw = _case_lw(name, N_RANK, dtype)
    u = jax.random.uniform(jax.random.PRNGKey(CASES.index(name)), (),
                           lw.dtype)
    want = np.asarray(jres._grid_parents(jres._normalized_cdf(lw), u,
                                         N_RANK))
    got = tres.systematic_parents(None, tensor(np.asarray(lw)),
                                  u=tensor(np.asarray(u))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < N_RANK
    assert np.all(np.diff(got) >= 0)
    counts = np.bincount(got, minlength=N_RANK)
    expect = N_RANK * np.exp(np.asarray(lw, np.float64))
    assert np.all(np.abs(counts - expect) <= 1.0 + 1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ordered_cumsum_matches_xla(dtype):
    for n in (7, 16, 100, 5000, 1 << 14):
        x = np.random.default_rng(n).exponential(size=n).astype(dtype)
        np.testing.assert_array_equal(ordered_cumsum(tensor(x)).numpy(),
                                      np.asarray(jnp.cumsum(jnp.asarray(x))))


def _weights(seed, n=64, scale=1.5):
    lw = jax.random.normal(jax.random.PRNGKey(seed), (n,)) * scale
    return lw - jax.scipy.special.logsumexp(lw)


@pytest.mark.parametrize("name", ["multinomial", "stratified", "residual"])
def test_schemes_bitwise_on_injected_uniforms(name):
    """The reference's uniforms, drawn as its scheme draws them, injected
    into the port's: the integer stages give the same ancestors."""
    for seed in range(4):
        lw = _weights(seed, n=256, scale=2.0)
        key = jax.random.PRNGKey(10 + seed)
        want = np.asarray(jres.RESAMPLERS[name](key, lw))
        shape = () if name == "residual" else (256,)
        draw = tensor(np.asarray(jax.random.uniform(key, shape, lw.dtype)))
        kw = {"u": draw} if name == "residual" else {"us": draw}
        got = tres.RESAMPLERS[name](None, tensor(np.asarray(lw)), **kw)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["multinomial", "systematic", "stratified",
                                  "residual"])
def test_unbiased_offspring_counts(name):
    """tests/test_resampling_schemes.py:23-40 on the port's own streams."""
    n, lw = 64, _weights(0)
    w = np.exp(np.asarray(lw, np.float64))
    w = w / w.sum()
    lw_t = tensor(np.asarray(lw))
    reps, counts = 3000, np.zeros(n)
    for r in range(reps):
        parents = tres.RESAMPLERS[name](r + 1, lw_t).numpy()
        assert parents.shape == (n,)
        assert parents.min() >= 0 and parents.max() < n
        counts += np.bincount(parents, minlength=n)
    se = np.sqrt(n * w * (1 - w) / reps) + 1e-3
    np.testing.assert_array_less(np.abs(counts / reps - n * w), 5 * se + 0.05)


@pytest.mark.parametrize("name", ["systematic", "stratified", "residual"])
def test_low_variance_count_bounds(name):
    """tests/test_resampling_schemes.py:43-62."""
    n, lw = 64, _weights(1)
    w = np.exp(np.asarray(lw, np.float64))
    w = w / w.sum()
    lo, hi = np.floor(n * w) - 1e-9, np.ceil(n * w) + 1e-9
    for r in range(50):
        counts = np.bincount(tres.RESAMPLERS[name](r + 100, tensor(
            np.asarray(lw))).numpy(), minlength=n)
        if name == "residual":
            assert np.all(counts >= lo)
        elif name == "systematic":
            assert np.all(counts >= lo) and np.all(counts <= hi + 1)
        else:
            assert np.all(counts >= lo - 1) and np.all(counts <= hi + 2)


def test_degenerate_weight_single_parent():
    lw = torch.full((64,), -torch.inf, dtype=torch.float64)
    lw[17] = 0.0
    for name, fn in tres.RESAMPLERS.items():
        assert bool((fn(0, lw) == 17).all()), name


@pytest.mark.parametrize("c", [1, 2, 7])
def test_systematic_resample_fused_matches_reference(c):
    """The key-taking fused entry, plain on the CPU, vs the interpret-mode
    Pallas entry on the same uniform: parents and states bitwise; parents
    also equal systematic_parents'."""
    n = 1024
    lw = _case_lw("peaked", n, jnp.float32)
    key = jax.random.PRNGKey(c)
    state_t = (np.random.default_rng(c).standard_normal((c, n)) * 2.0
               ).astype(np.float32)
    j_new, j_parents = j_systematic_resample_fused(
        key, lw, jnp.asarray(state_t), interpret=True)
    u = tensor(np.asarray(jax.random.uniform(key, (), lw.dtype)))
    new, parents = fused_resample.systematic_resample_fused(
        None, tensor(np.asarray(lw)), tensor(state_t), u=u)
    np.testing.assert_array_equal(parents.numpy(), np.asarray(j_parents))
    np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(
        tres.systematic_parents(None, tensor(np.asarray(lw)), u=u).numpy(),
        parents.numpy())
    # the filter's (N, C) layout and pytree entries: not fusable on the CPU
    state_nc = tensor(state_t.T.copy())
    assert tres.fused_systematic_resample_or_none(
        None, tensor(np.asarray(lw)), state_nc) is None
    s = resample.slot_positions(tres.normalized_cdf(tensor(np.asarray(lw))),
                                u, n)
    assert tres.fused_gather_from_s_or_none(s, state_nc) is None
    np.testing.assert_array_equal(
        tres.gather_particles(state_nc, parents).numpy(), np.asarray(j_new).T)
    assert fused_resample.resample_fused_from_s.launches == 0


def test_gather_particles_pytree():
    rng = np.random.default_rng(5)
    tree = {"z": tensor(rng.integers(0, 3, 50).astype(np.int32)),
            "x": (tensor(rng.standard_normal((50, 3))),)}
    parents = torch.tensor(np.sort(rng.integers(0, 50, 50)), dtype=torch.int32)
    out = tres.gather_particles(tree, parents)
    p = parents.numpy()
    np.testing.assert_array_equal(out["z"].numpy(), tree["z"].numpy()[p])
    np.testing.assert_array_equal(out["x"][0].numpy(), tree["x"][0].numpy()[p])


def test_categorical_logpdf_matches_reference():
    """In and out of support, a shared (K,) vector and per-particle (n, K)
    rows, at 1e-12."""
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(4), size=6)
    xs = np.array([0, 3, 2, -1, 4, 1])
    want = np.asarray(jax.vmap(lambda x, p: j_categorical.logpdf(x, (p,)))(
        jnp.asarray(xs), jnp.asarray(probs)))
    got = categorical.logpdf(tensor(xs), (tensor(probs),)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert np.isneginf(got[3]) and np.isneginf(got[4])
    want_one = np.asarray(jax.vmap(lambda x: j_categorical.logpdf(
        x, (jnp.asarray(probs[0]),)))(jnp.asarray(xs)))
    np.testing.assert_allclose(
        categorical.logpdf(tensor(xs), (tensor(probs[0]),)).numpy(),
        want_one, rtol=1e-12, atol=0)
    # a scalar observation against per-particle rows: one score each
    got2 = categorical.logpdf(torch.tensor(2), (tensor(probs),)).numpy()
    np.testing.assert_allclose(got2, np.log(probs[:, 2]), rtol=1e-12)


def test_categorical_draws():
    """(K,) probs draw an (n,) plate; (n, K) rows draw one per row; the
    frequencies match; a zero-probability index is never drawn."""
    from modppl_tpu_torch.core.keys import generator

    probs = torch.tensor([0.2, 0.0, 0.5, 0.3], dtype=torch.float64)
    assert not categorical.batched((probs,))
    x = categorical.sample_batch(generator(1, "cpu"), (200_000,), (probs,))
    assert x.dtype == torch.int32 and x.shape == (200_000,)
    freq = np.bincount(x.numpy(), minlength=4) / x.shape[0]
    np.testing.assert_allclose(freq, probs.numpy(), atol=5e-3)
    rows = probs.repeat(5, 1)
    rows[:, 1], rows[:, 0] = rows[:, 0], 0.0
    assert categorical.batched((rows,))
    y = categorical.sample(generator(2, "cpu"), (rows,))
    assert y.shape == (5,) and not bool((y == 0).any())


def test_hmm_forward_matches_reference():
    for data in (GATE_DATA, [2, 1, 0, 0, 2, 1, 1]):
        want = float(jhmm.hmm_forward_alg(GATE_PRIOR, GATE_EMISSION,
                                          GATE_TRANSITION, data))
        got = float(hmm.hmm_forward_alg(GATE_PRIOR, GATE_EMISSION,
                                        GATE_TRANSITION, data))
        assert got == pytest.approx(want, rel=1e-12)
        want = float(jhmm.hmm_forward_log_ml(
            jnp.asarray(GATE_PRIOR), jnp.asarray(GATE_EMISSION),
            jnp.asarray(GATE_TRANSITION), jnp.asarray(data)))
        got = float(hmm.hmm_forward_log_ml(GATE_PRIOR, GATE_EMISSION,
                                           GATE_TRANSITION, data))
        assert got == pytest.approx(want, rel=1e-12)


def _hmm_filter(key, prior, emission, transition, data, n, **kw):
    """The port's filter through interop's HMMParams, float64 on the CPU."""
    jp = jhmm.HMMParams(prior, emission, transition)
    params = hmm_params_from_numpy(np.asarray(jp.prior),
                                   np.asarray(jp.emission_matrix),
                                   np.asarray(jp.transition_matrix))
    init_c = Trie.from_dict({"obs": torch.tensor(data[0])})
    step_c = Trie.from_dict({"obs": torch.tensor(data[1:])})
    return batched_particle_filter(
        key, hmm.hmm_scan_kernel(params), torch.zeros((), dtype=torch.float64),
        init_c, step_c, n, auto_batch=True, device="cpu", **kw)


@pytest.mark.parametrize("resampling", ["systematic", "multinomial"])
def test_hmm_filter_lml_gate(resampling):
    """tests/test_vsmc.py:26-59: 10^4 particles within 0.03 of the exact
    log-ML; the weights are per particle and the state stays int32."""
    expected = float(hmm.hmm_forward_log_ml(GATE_PRIOR, GATE_EMISSION,
                                            GATE_TRANSITION, GATE_DATA))
    out = _hmm_filter(0, GATE_PRIOR, GATE_EMISSION, GATE_TRANSITION,
                      GATE_DATA, 10_000, resampling=resampling)
    assert float(out["log_ml"]) == pytest.approx(expected, abs=0.03)
    assert out["log_weights"].shape == (10_000,)
    assert len(torch.unique(out["log_weights"])) > 1
    assert out["state"].dtype == torch.int32
    assert out["ancestors"].shape == (3, 10_000)
    assert bool(out["resampled"].all())
    if resampling == "systematic":
        anc = out["ancestors"]
        assert not bool((anc[:, 1:] < anc[:, :-1]).any())


def test_hmm_filter_adaptive_resampling():
    """tests/test_vsmc.py:62-79: threshold 0.5 skips at least one resample
    and stays within 0.05 of the exact log-ML."""
    prior = np.array([0.5, 0.5])
    emission = np.array([[0.9, 0.1], [0.1, 0.9]])
    transition = np.array([[0.8, 0.2], [0.2, 0.8]])
    data = [0, 0, 1, 1, 0]
    expected = float(hmm.hmm_forward_log_ml(prior, emission, transition,
                                            data))
    out = _hmm_filter(2, prior, emission, transition, data, 5000,
                      ess_threshold=0.5)
    assert float(out["log_ml"]) == pytest.approx(expected, abs=0.05)
    assert not bool(out["resampled"].all())
    skipped = ~out["resampled"]
    slots = torch.arange(5000, dtype=torch.int32)
    assert bool((out["ancestors"][skipped] == slots).all())


def test_spiral_through_vsmc():
    """The spiral's float32 state through vsmc's filter on the CPU: the
    unfused arm (systematic_parents + gather_particles), finite log-ML,
    sorted ancestors."""
    obs = torch.tensor(circle_observations(6), dtype=torch.float32)
    out = batched_particle_filter(
        5, spiral_scan_kernel(), torch.zeros(2),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}),
        4096, auto_batch=True, device="cpu")
    assert np.isfinite(float(out["log_ml"]))
    assert out["state"].shape == (4096, 2)
    anc = out["ancestors"]
    assert not bool((anc[:, 1:] < anc[:, :-1]).any())


def test_guided_and_rejuvenated_filters_raise():
    """tests/test_batched_filter.py::test_batched_guided_requires_auto_batch:
    a batch-aware kernel (auto_batch=False) takes no proposal and no
    rejuvenation; the guided and rejuvenated filters need the per-particle
    kernel."""
    params = hmm.HMMParams(torch.tensor(GATE_PRIOR),
                           torch.tensor(GATE_EMISSION),
                           torch.tensor(GATE_TRANSITION))
    init_c = Trie.from_dict({"obs": torch.tensor(0)})
    step_c = Trie.from_dict({"obs": torch.tensor([1])})
    for kw in ({"proposal": object()}, {"rejuvenation": (select("z"), 1)}):
        with pytest.raises(ValueError, match="auto_batch"):
            batched_particle_filter(0, hmm.hmm_scan_kernel(params),
                                    torch.zeros(()), init_c, step_c, 8,
                                    device="cpu", **kw)
