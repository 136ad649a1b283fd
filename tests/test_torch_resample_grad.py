"""Kernel 3 under autograd and chain-blocked resampling (CPU).

The reference differentiates the fused gather as an XLA ``take`` of the
state by the ancestors, whose adjoint is a scatter-add into the ancestors'
rows. The port's plain path (``gather_from_s`` on a CPU tensor) and the
kernel arm's ``autograd.Function`` (``ops/fused_resample._FusedGather``,
its forward swapped for the plain version here, as there is no card) must
give ``jax.grad``'s gradient on the same S, to 1e-12 in float64.

Chain-blocked resampling (``parallel/resample.blocked_resample``) must
equal C separate one-chain resamples bitwise, and a chain whose weights
are NaN must leave every other chain's ancestors unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.parallel.sharded_smc import (
    _parents_from_s as j_parents_from_s,
)
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.ops import fused_resample
from modppl_tpu_torch.ops.resample import slot_positions, systematic_parents
from modppl_tpu_torch.parallel.resample import (
    blocked_resample,
    gather_from_s,
    multinomial_parents,
    stratified_parents,
)
from modppl_tpu_torch.utils.numerics import normalized_cdf
from _torch_threads import one_thread  # noqa: F401

N = 96
GRAD_TOL = dict(rtol=1e-12, atol=1e-12)


def _log_norm(kind, n, seed, rows=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if rows is None else (rows, n)
    if kind == "uniform":
        lw = rng.standard_normal(shape) * 0.7
    elif kind == "concentrated":
        lw = rng.standard_normal(shape) * 30.0
    else:
        lw = np.full(shape, -np.inf)
        if rows is None:
            lw[rng.integers(n)] = 0.0
        else:
            lw[np.arange(rows), rng.integers(n, size=rows)] = 0.0
    lw = torch.from_numpy(lw)
    return lw - torch.logsumexp(lw, -1, keepdim=True)


def _s(kind, seed):
    lw = _log_norm(kind, N, seed)
    return slot_positions(normalized_cdf(lw), 0.37, N)


def _jax_grad(s, state, cot):
    parents = j_parents_from_s(jnp.asarray(s.numpy()), s.shape[0])

    def loss(x):
        return jnp.sum(jnp.take(x, parents, axis=0) * jnp.asarray(cot))

    return np.asarray(jax.grad(loss)(jnp.asarray(state)))


@pytest.mark.parametrize("kind", ["uniform", "concentrated", "degenerate"])
def test_gather_from_s_gradient_matches_jax_grad(kind):
    """The plain path: a two-leaf filter state that requires grad, gathered
    by ``gather_from_s``; the gradient of a weighted sum of the output is
    jax.grad's of the reference's take."""
    rng = np.random.default_rng(7)
    s = _s(kind, 1)
    a = rng.standard_normal((N,))
    b = rng.standard_normal((N, 3))
    cot_a, cot_b = rng.standard_normal((N,)), rng.standard_normal((N, 3))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    new, parents = gather_from_s(s, {"a": ta, "b": tb})
    assert parents.grad_fn is None and not parents.requires_grad
    loss = (new["a"] * tensor(cot_a)).sum() + (new["b"] * tensor(cot_b)).sum()
    ga, gb = torch.autograd.grad(loss, (ta, tb))
    np.testing.assert_allclose(ga.numpy(), _jax_grad(s, a, cot_a), **GRAD_TOL)
    np.testing.assert_allclose(gb.numpy(), _jax_grad(s, b, cot_b), **GRAD_TOL)


@pytest.mark.parametrize("layout", ["nc", "cn"])
def test_fused_gather_function_backward(monkeypatch, layout):
    """The kernel arm's autograd.Function with its forward swapped for the
    plain version: the same state as the plain path, jax.grad's gradient,
    no gradient on the parents, and a second derivative raises rather than
    returning a result without one."""
    monkeypatch.setattr(fused_resample, "_launch",
                        fused_resample.resample_fused_plain)
    rng = np.random.default_rng(3)
    s = _s("uniform", 2)
    x = rng.standard_normal((N, 5))
    cot = rng.standard_normal((N, 5))
    state = torch.tensor(x if layout == "nc" else x.T.copy(),
                         requires_grad=True)
    new, parents = fused_resample._FusedGather.apply(s, state, layout)
    plain, plain_parents = fused_resample.resample_fused_plain(s, state,
                                                               layout)
    assert torch.equal(new, plain) and torch.equal(parents, plain_parents)
    assert new.grad_fn is not None and parents.grad_fn is None
    c = tensor(cot if layout == "nc" else cot.T.copy())
    (g,) = torch.autograd.grad((new * c).sum(), state, create_graph=True)
    want = _jax_grad(s, x, cot)
    np.testing.assert_allclose(g.numpy() if layout == "nc" else g.numpy().T,
                               want, **GRAD_TOL)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), state)


def _one_chain(scheme, log_norm, u):
    if scheme == "systematic":
        return systematic_parents(None, log_norm, u=u)
    fn = multinomial_parents if scheme == "multinomial" else stratified_parents
    return fn(None, log_norm, us=u)


@pytest.mark.parametrize("kind", ["uniform", "concentrated", "degenerate"])
@pytest.mark.parametrize("scheme", ["systematic", "multinomial",
                                    "stratified"])
def test_blocked_resample_equals_one_chain_resamples(kind, scheme):
    """C = 5 chains of N on one axis: the parents are chain c's one-chain
    parents + c N and the state rows are gathered by them, bitwise."""
    c = 5
    log_norm = _log_norm(kind, N, 11, rows=c)
    rng = np.random.default_rng(12)
    u = torch.from_numpy(rng.uniform(size=(c,) if scheme == "systematic"
                                     else (c, N)))
    state = torch.from_numpy(rng.standard_normal((c * N, 2)))
    new, parents = blocked_resample(scheme, log_norm, state, u)
    for i in range(c):
        want = _one_chain(scheme, log_norm[i], u[i]).long() + i * N
        assert torch.equal(parents[i * N:(i + 1) * N].long(), want)
    assert torch.equal(new, state[parents.long()])


@pytest.mark.parametrize("scheme", ["systematic", "multinomial"])
def test_nan_chain_leaves_other_chains_bitwise(scheme):
    """Chain 2's weights all NaN: its S is garbage, but every other chain's
    ancestors are bitwise those of the same call with chain 2 finite, and
    chain 2's stay inside its own block."""
    c = 4
    log_norm = _log_norm("uniform", N, 21, rows=c)
    rng = np.random.default_rng(22)
    u = torch.from_numpy(rng.uniform(size=(c,) if scheme == "systematic"
                                     else (c, N)))
    state = torch.arange(c * N, dtype=torch.float64)[:, None]
    _, clean = blocked_resample(scheme, log_norm, state, u)
    bad = log_norm.clone()
    bad[2] = float("nan")
    _, dirty = blocked_resample(scheme, bad, state, u)
    keep = torch.ones(c * N, dtype=torch.bool)
    keep[2 * N:3 * N] = False
    assert torch.equal(clean[keep], dirty[keep])
    block = dirty[2 * N:3 * N]
    assert bool(((block >= 2 * N) & (block < 3 * N)).all())
