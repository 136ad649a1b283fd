"""FIVO (``inference/fivo.py``) on the CPU: the value and gradient of
``fivo_objective`` and three steps of ``fit_proposal`` against the
reference's on its own draws, the two FIVO tests of
``tests/test_batched_filter.py`` at their bounds, and the gradient's path
through resampling.

Parity: the reference's draws are rebuilt from its key chain (the init's,
each step's resample uniform, the proposal's per-particle standard
normals) and replayed into the port, the proposal's as ``Standard`` draws
so that x = mu + std z keeps its gradient; value, gradient and trained
parameters must agree with ``jax.value_and_grad`` / the reference's
``fit_proposal`` to 1e-10 in float64.

The filter's gradient must survive resampling on either arm of kernel 3:
with the fused arm forced on for CPU tensors (its launch swapped for the
plain version, so that ``ops/fused_resample._FusedGather`` carries the
gradient), the gradient of a systematically resampled bound equals the one
through the plain gather to 1e-12. A batch of runs in one chain-blocked
filter has the mean of the runs' gradients.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from modppl_tpu import Trie as JTrie
from modppl_tpu import gen as jgen
from modppl_tpu.dists import normal as j_normal
from modppl_tpu.inference.vsmc import ScanKernel as JScanKernel
from modppl_tpu.modeling.handlers import addr_subkey
from modppl_tpu_torch.core.keys import split, split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import Standard, normal
from modppl_tpu_torch.inference.blocked_smc import blocked_particle_filter
from modppl_tpu_torch.inference.fivo import fit_proposal, fivo_objective
from modppl_tpu_torch.inference.vsmc import ScanKernel
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.ops import fused_resample
from modppl_tpu_torch.parallel import resample
from _torch_threads import one_thread  # noqa: F401

A, Q, R = 0.9, 0.5, 0.3
YS = np.array([0.3, 0.5, 0.1, -0.2, 0.4, 0.9, 0.7, 0.2])
PREC = 1.0 / Q ** 2 + 1.0 / R ** 2


@pytest.fixture(autouse=True)
def _float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


@gen
def lg_init(h, _s0):
    x = h.sample(normal, (0.0, 1.0), "x")
    h.sample(normal, (x, R), "y")
    return x


@gen
def lg_step(h, t, prev):
    x = h.sample(normal, (A * prev, Q), "x")
    h.sample(normal, (x, R), "y")
    return x


@gen
def lg_learnable_proposal(h, t, prev, cons, params):
    y = cons.read("y")
    m = params["w_prev"] * prev + params["w_obs"] * y + params["bias"]
    h.sample(normal, (m, F.softplus(params["raw_std"])), "x")


KERNEL = ScanKernel(lg_init, lg_step)

# the packages export the function fivo_objective; the module by its path
jfivo = importlib.import_module("modppl_tpu.inference.fivo")


@jgen
def j_lg_init(h, _s0):
    x = h.sample(j_normal, (0.0, 1.0), "x")
    h.sample(j_normal, (x, R), "y")
    return x


@jgen
def j_lg_step(h, t, prev):
    x = h.sample(j_normal, (A * prev, Q), "x")
    h.sample(j_normal, (x, R), "y")
    return x


@jgen
def j_lg_learnable_proposal(h, t, prev, cons, params):
    y = cons.read("y")
    m = params["w_prev"] * prev + params["w_obs"] * y + params["bias"]
    h.sample(j_normal, (m, jax.nn.softplus(params["raw_std"])), "x")


J_KERNEL = JScanKernel(j_lg_init, j_lg_step)
PARITY = dict(rtol=1e-10, atol=1e-12)


def kalman_log_ml(ys):
    mu, var, total = 0.0, 1.0, 0.0
    for t, y in enumerate(ys):
        if t > 0:
            mu, var = A * mu, A * A * var + Q * Q
        s = var + R * R
        total += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k = var / s
        mu, var = mu + k * (y - mu), (1 - k) * var
    return total


def _constraints():
    return (Trie.from_dict({"y": torch.tensor(YS[0])}),
            Trie.from_dict({"y": torch.tensor(YS[1:])}))


def _params(w_prev, w_obs, bias, raw_std, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in
            (("w_prev", w_prev), ("w_obs", w_obs), ("bias", bias),
             ("raw_std", raw_std))}


def _optimal(grad=False):
    return _params(A / Q ** 2 / PREC, 1.0 / R ** 2 / PREC, 0.0,
                   float(np.log(np.expm1(1.0 / np.sqrt(PREC)))), grad)


# --- the reference's draws, rebuilt from its key chain ---------------------

def _lane_normals(keys, addr):
    """The per-particle standard normals of the vmapped tier (one key a
    particle) at ``addr``."""
    return np.asarray(jax.vmap(lambda k: jax.random.normal(
        addr_subkey(k, addr), (), jnp.float64))(keys))


def _plate_normals(key, addr, n):
    """The batched tier's per-particle draws at ``addr``: one stream a
    particle, ``fold_in(addr_subkey(key, addr), i)``."""
    return np.asarray(jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(addr_subkey(key, addr), i), (), jnp.float64))(
        jnp.arange(n)))


def _run_draws(key, n, auto_batch):
    """One reference run's randoms (systematic resampling, a proposal):
    the init's standard normals, then each step's uniform and the
    proposal's standard normals. The vmapped tier splits as vsmc.py:72-73
    and :165-177, the batched tier as :208 and :239-250."""
    if auto_batch:
        k_gen, carry = jax.random.split(key)
        init = np.asarray(jax.random.normal(addr_subkey(k_gen, "x"), (n,),
                                            jnp.float64))
    else:
        k_sim, carry = jax.random.split(key)
        init = _lane_normals(jax.random.split(k_sim, n), "x")
    steps = []
    for _ in range(len(YS) - 1):
        if auto_batch:
            carry, k_res, k_gen = jax.random.split(carry, 3)
            z = _plate_normals(jax.random.split(k_gen)[0], "x", n)
        else:
            carry, k_res, k_gen, _ = jax.random.split(carry, 4)
            k_prop = jax.vmap(lambda k: jax.random.split(k)[0])(
                jax.random.split(k_gen, n))
            z = _lane_normals(k_prop, "x")
        steps.append((np.asarray(jax.random.uniform(k_res, (), jnp.float64)),
                      z))
    return init, steps


def _replay(keys, n, auto_batch):
    """The runs keyed ``keys`` as one chain-blocked filter's replay: chain
    b's uniforms at b, its draws on its block of lanes."""
    runs = [_run_draws(k, n, auto_batch) for k in keys]
    out = [(None, {"x": Standard(tensor(np.concatenate(
        [init for init, _ in runs])))})]
    for i in range(len(YS) - 1):
        u = tensor(np.stack([steps[i][0] for _, steps in runs]))
        z = tensor(np.concatenate([steps[i][1] for _, steps in runs]))
        out.append((u, {}, {"x": Standard(z)}, None))
    return out


def _j_params(vals):
    return {k: jnp.asarray(v) for k, v in zip(
        ("w_prev", "w_obs", "bias", "raw_std"), vals)}


def _j_constraints():
    init_c = JTrie.from_dict({"y": jnp.asarray(YS[0])})
    step_c = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[JTrie.from_dict({"y": jnp.asarray(y)}) for y in YS[1:]])
    return init_c, step_c


@pytest.mark.parametrize("auto_batch", [False, True])
def test_fivo_objective_value_and_gradient_match_reference(auto_batch):
    """Systematic, every step resampling, on the reference's draws: the
    bound and its gradient with respect to every parameter are
    jax.value_and_grad's of the reference's fivo_objective."""
    n, vals = 64, (0.3, 0.4, 0.1, 0.2)
    key = jax.random.PRNGKey(11)
    jic, jsc = _j_constraints()
    want, jgrad = jax.value_and_grad(lambda p: jfivo.fivo_objective(
        key, J_KERNEL, j_lg_learnable_proposal, p, jnp.zeros(()), jic, jsc,
        n, resampling="systematic", ess_threshold=1.0,
        auto_batch=auto_batch))(_j_params(vals))
    init_c, step_c = _constraints()
    params = _params(*vals, grad=True)
    got = fivo_objective(0, KERNEL, lg_learnable_proposal, params,
                         torch.zeros(()), init_c, step_c, n,
                         resampling="systematic", ess_threshold=1.0,
                         auto_batch=auto_batch,
                         replay=_replay([key], n, auto_batch), device="cpu")
    grad = torch.autograd.grad(got, tuple(params.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), **PARITY)
    for g, name in zip(grad, params):
        np.testing.assert_allclose(float(g), float(jgrad[name]), **PARITY,
                                   err_msg=name)
    assert all(float(g) != 0.0 for g in grad)


def test_fit_proposal_matches_reference():
    """Three steps of fit_proposal with a batch of 3 runs a step (one
    chain-blocked filter, resampling every step) on the reference's
    draws: the bounds and the trained parameters are the reference's.
    Adam's later steps weigh each gradient by the earlier ones, so a wrong
    gradient moves the parameters."""
    n, num_steps, batch = 32, 3, 3
    key = jax.random.PRNGKey(5)
    jic, jsc = _j_constraints()
    vals = (0.0, 0.0, 0.0, 0.5)
    kw = dict(num_steps=num_steps, learning_rate=0.05, batch_size=batch,
              resampling="systematic", ess_threshold=1.0)
    jparams, jbounds = jfivo.fit_proposal(
        key, J_KERNEL, j_lg_learnable_proposal, _j_params(vals),
        jnp.zeros(()), jic, jsc, n, **kw)
    replay = [_replay(jax.random.split(k, batch), n, False)
              for k in jax.random.split(key, num_steps)]
    init_c, step_c = _constraints()
    params, bounds = fit_proposal(
        0, KERNEL, lg_learnable_proposal, _params(*vals), torch.zeros(()),
        init_c, step_c, n, replay=replay, device="cpu", **kw)
    np.testing.assert_allclose(bounds.numpy(), np.asarray(jbounds), **PARITY)
    for name, p in params.items():
        np.testing.assert_allclose(float(p), float(jparams[name]), **PARITY,
                                   err_msg=name)


def test_fivo_auto_batch_objective_and_grads():
    """tests/test_batched_filter.py:252-282."""
    init_c, step_c = _constraints()
    want = kalman_log_ml(YS)
    params = _optimal(grad=True)

    def obj(k):
        return fivo_objective(k, KERNEL, lg_learnable_proposal, params,
                              torch.zeros(()), init_c, step_c, 1024,
                              ess_threshold=0.0, auto_batch=True,
                              device="cpu")

    vals = [float(obj(i).detach()) for i in range(3)]
    assert np.mean(vals) == pytest.approx(want, abs=0.1)
    g = torch.autograd.grad(obj(7), tuple(params.values()))
    assert all(bool(torch.isfinite(x)) for x in g)
    assert abs(float(g[1])) < 0.5


def _force_fused_arm(monkeypatch):
    """The fused arm for CPU float64 states, kernel 3's Function with its
    launch swapped for the plain version."""
    def fusable(n, tree):
        leaves, spec = resample.pytree.tree_flatten(tree)
        return (leaves, spec) if all(x.shape[0] == n for x in leaves) else None

    def kernel_arm(s, state, layout="cn"):
        return fused_resample._FusedGather.apply(s, state, layout)

    monkeypatch.setattr(resample, "_fusable", fusable)
    monkeypatch.setattr(fused_resample, "_launch",
                        fused_resample.resample_fused_plain)
    for module in (resample, fused_resample):
        monkeypatch.setattr(module, "resample_fused_from_s", kernel_arm)


@pytest.mark.parametrize("auto_batch", [True, False])
def test_gradient_through_kernel3_arm_equals_plain(monkeypatch, auto_batch):
    """fivo_objective, systematic at ess_threshold 1.0 (every step
    resamples): the value and gradient through the fused arm's
    autograd.Function equal those through the plain gather."""
    init_c, step_c = _constraints()

    def value_and_grad():
        params = _params(0.3, 0.4, 0.1, 0.2, grad=True)
        val = fivo_objective(3, KERNEL, lg_learnable_proposal, params,
                             torch.zeros(()), init_c, step_c, 256,
                             resampling="systematic", ess_threshold=1.0,
                             auto_batch=auto_batch, device="cpu")
        return val, torch.stack(torch.autograd.grad(val,
                                                    tuple(params.values())))

    plain_val, plain_grad = value_and_grad()
    calls = []
    _force_fused_arm(monkeypatch)
    apply = fused_resample._FusedGather.apply
    monkeypatch.setattr(fused_resample._FusedGather, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    val, grad = value_and_grad()
    assert len(calls) == len(YS) - 1
    assert torch.equal(val, plain_val)
    assert bool((plain_grad != 0).all())
    np.testing.assert_allclose(grad.numpy(), plain_grad.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_blocked_batch_gradient_is_the_mean_of_the_runs():
    """fit_proposal's batch: one chain-blocked filter of 3 runs (resampling
    each step) has the mean of the three one-run gradients."""
    init_c, step_c = _constraints()
    keys = split_keys(4, 3, "cpu")

    def grad_of(ks):
        params = _params(0.3, 0.4, 0.1, 0.2, grad=True)
        out = blocked_particle_filter(
            ks, KERNEL, torch.zeros(()), init_c, step_c, 128,
            resampling="multinomial", ess_threshold=1.0,
            proposal=lg_learnable_proposal, proposal_params=params,
            device="cpu")
        return torch.stack(torch.autograd.grad(out["log_ml"].mean(),
                                               tuple(params.values())))

    whole = grad_of(keys)
    each = torch.stack([grad_of(keys[i:i + 1]) for i in range(3)]).mean(0)
    np.testing.assert_allclose(whole.numpy(), each.numpy(), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("auto_batch", [False, True])
def test_a_batch_run_is_the_objective_of_its_key(auto_batch):
    """One code path: run b of fit_proposal's chain-blocked batch keyed k
    is fivo_objective keyed split(k, B)[b], bitwise."""
    init_c, step_c = _constraints()
    params = _params(0.3, 0.4, 0.1, 0.2)
    kw = dict(resampling="systematic", ess_threshold=1.0,
              auto_batch=auto_batch, device="cpu")
    out = blocked_particle_filter(
        split_keys(4, 3, "cpu"), KERNEL, torch.zeros(()), init_c, step_c, 64,
        proposal=lg_learnable_proposal, proposal_params=params, **kw)
    each = torch.stack([fivo_objective(
        k, KERNEL, lg_learnable_proposal, params, torch.zeros(()), init_c,
        step_c, 64, **kw) for k in split(4, 3)])
    assert torch.equal(out["log_ml"], each)


def test_fivo_learns_optimal_proposal():
    """tests/test_batched_filter.py:151-183 at its configuration (N 256,
    400 steps, lr 0.03, batch 4, no resampling) and bounds."""
    init_c, step_c = _constraints()
    params0 = _params(0.0, 0.0, 0.0, 0.5)
    params, bounds = fit_proposal(
        0, KERNEL, lg_learnable_proposal, params0, torch.zeros(()), init_c,
        step_c, 256, num_steps=400, learning_rate=0.03, batch_size=4,
        ess_threshold=0.0, device="cpu")
    assert bounds.shape == (400,)
    assert float(params["w_obs"]) == pytest.approx(1.0 / R ** 2 / PREC,
                                                   abs=0.15)
    assert float(F.softplus(params["raw_std"])) == pytest.approx(
        1.0 / math.sqrt(PREC), abs=0.1)
    want = kalman_log_ml(YS)

    def bound_stats(p):
        vals = torch.stack([fivo_objective(
            k, KERNEL, lg_learnable_proposal, p, torch.zeros(()), init_c,
            step_c, 256, device="cpu") for k in range(99, 131)])
        return float(vals.mean()), float(vals.std())

    mean_tr, std_tr = bound_stats(params)
    _, std_init = bound_stats(params0)
    assert std_tr < 0.5 * std_init
    assert mean_tr == pytest.approx(want, abs=0.1)


# --- chain-blocked residual resampling -------------------------------------

@pytest.mark.parametrize("c", [1, 3, 8])
def test_blocked_residual_is_residual_parents_per_chain(c):
    """Chain b's parents are residual_parents of its own weights and
    uniform, + b N, bitwise; a NaN chain keeps its parents in its block
    and moves no other chain."""
    n = 96
    rng = np.random.default_rng(c)
    lw = torch.from_numpy(rng.standard_normal((c, n)) * 2.0)
    lw = lw - torch.logsumexp(lw, 1, keepdim=True)
    u = torch.from_numpy(rng.random(c))
    state = torch.arange(c * n, dtype=torch.float64)[:, None]
    for bad in ([], [c // 2]):
        lw_b = lw.clone()
        lw_b[bad] = float("nan")
        new, parents = resample.blocked_resample("residual", lw_b, state, u)
        for b in range(c):
            block = parents[b * n:(b + 1) * n]
            assert int(block.min()) >= b * n and int(block.max()) < (b + 1) * n
            want = resample.residual_parents(None, lw_b[b], u=u[b]) + b * n
            assert torch.equal(block, want), b
        assert torch.equal(new[:, 0], parents.to(torch.float64))


@pytest.mark.parametrize("auto_batch", [False, True])
def test_fivo_objective_residual_matches_reference(auto_batch):
    """``resampling="residual"``, every step resampling, on the reference's
    draws (residual takes the systematic step's one uniform): the bound
    and its gradient are jax.value_and_grad's of the reference's."""
    n, vals = 64, (0.3, 0.4, 0.1, 0.2)
    key = jax.random.PRNGKey(13)
    jic, jsc = _j_constraints()
    want, jgrad = jax.value_and_grad(lambda p: jfivo.fivo_objective(
        key, J_KERNEL, j_lg_learnable_proposal, p, jnp.zeros(()), jic, jsc,
        n, resampling="residual", ess_threshold=1.0,
        auto_batch=auto_batch))(_j_params(vals))
    init_c, step_c = _constraints()
    params = _params(*vals, grad=True)
    got = fivo_objective(0, KERNEL, lg_learnable_proposal, params,
                         torch.zeros(()), init_c, step_c, n,
                         resampling="residual", ess_threshold=1.0,
                         auto_batch=auto_batch,
                         replay=_replay([key], n, auto_batch), device="cpu")
    grad = torch.autograd.grad(got, tuple(params.values()))
    np.testing.assert_allclose(float(got.detach()), float(want), **PARITY)
    for g, name in zip(grad, params):
        np.testing.assert_allclose(float(g), float(jgrad[name]), **PARITY,
                                   err_msg=name)


def test_fit_proposal_residual_matches_reference():
    """Two steps of a batch of 3 runs, residual: one chain-blocked filter
    whose every chain resamples in its own block, on the reference's
    draws."""
    n, num_steps, batch = 32, 2, 3
    key = jax.random.PRNGKey(8)
    jic, jsc = _j_constraints()
    vals = (0.0, 0.0, 0.0, 0.5)
    kw = dict(num_steps=num_steps, learning_rate=0.05, batch_size=batch,
              resampling="residual", ess_threshold=1.0)
    jparams, jbounds = jfivo.fit_proposal(
        key, J_KERNEL, j_lg_learnable_proposal, _j_params(vals),
        jnp.zeros(()), jic, jsc, n, **kw)
    replay = [_replay(jax.random.split(k, batch), n, False)
              for k in jax.random.split(key, num_steps)]
    init_c, step_c = _constraints()
    params, bounds = fit_proposal(
        0, KERNEL, lg_learnable_proposal, _params(*vals), torch.zeros(()),
        init_c, step_c, n, replay=replay, device="cpu", **kw)
    np.testing.assert_allclose(bounds.numpy(), np.asarray(jbounds), **PARITY)
    for name, p in params.items():
        np.testing.assert_allclose(float(p), float(jparams[name]), **PARITY,
                                   err_msg=name)


def test_fivo_residual_bound_on_its_own_streams():
    """The residual bound's mean over keys on the port's own streams within
    the Monte Carlo bound of tests/test_batched_filter.py:252-282 (0.1) of
    the reference's on its own, and its gradient finite."""
    init_c, step_c = _constraints()
    jic, jsc = _j_constraints()
    params = _optimal(grad=True)
    jparams = _j_params([float(v.detach()) for v in params.values()])
    kw = dict(resampling="residual", ess_threshold=1.0, auto_batch=True)
    ref = np.mean([float(jfivo.fivo_objective(
        jax.random.PRNGKey(i), J_KERNEL, j_lg_learnable_proposal, jparams,
        jnp.zeros(()), jic, jsc, 1024, **kw)) for i in range(3)])

    def obj(k):
        return fivo_objective(k, KERNEL, lg_learnable_proposal, params,
                              torch.zeros(()), init_c, step_c, 1024,
                              device="cpu", **kw)

    vals = [float(obj(i).detach()) for i in range(3)]
    assert np.mean(vals) == pytest.approx(ref, abs=0.1)
    assert np.mean(vals) == pytest.approx(kalman_log_ml(YS), abs=0.1)
    g = torch.autograd.grad(obj(7), tuple(params.values()))
    assert all(bool(torch.isfinite(x)) for x in g)
