"""Guided and rejuvenated SMC, port vs reference (CPU, float64).

Replayed: both filter entry points are fed the reference's own randoms,
rebuilt in JAX from the reference's key chain (the init plate, each step's
resample uniform, the proposal's per-particle draws, each move's regenerate
draws and accept uniforms), so both sides compute the same filter: the
ancestors must be bitwise equal, states, ESS and log-ML within rtol 1e-9.
Statistical: the reference's own gates (tests/test_batched_filter.py) on the
port's streams, against the exact Kalman log-ML, and the multivariate LGSSM
with rejuvenation against a numpy Kalman filter.
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
from modppl_tpu.dists.plate import plate as j_plate
from modppl_tpu.inference.vsmc import ScanKernel as JScanKernel
from modppl_tpu.inference.vsmc import batched_particle_filter as j_vsmc
from modppl_tpu.modeling.handlers import addr_subkey
from modppl_tpu.models import lgssm as jlgssm
from modppl_tpu.parallel.sharded_smc import (
    sharded_batched_particle_filter as j_sharded,
)
from modppl_tpu_torch.core import Trie, select
from modppl_tpu_torch.dists import Standard, normal, plate
from modppl_tpu_torch.inference.vsmc import (
    ScanKernel,
    _rejuvenate,
    batched_particle_filter,
)
from modppl_tpu_torch.interop import lgssm_params_from_numpy, tensor
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.autobatch import auto_batch_scan_kernel
from modppl_tpu_torch.models.lgssm import (
    lgssm_scan_kernel,
    lgssm_simulate,
    make_lgssm,
)
from modppl_tpu_torch.parallel.sharded_smc import (
    sharded_batched_particle_filter,
)
from _torch_threads import one_thread  # noqa: F401

A, Q, R = 0.9, 0.5, 0.3   # tests/test_batched_filter.py:23
YS = np.array([0.3, 0.5, 0.1, -0.2, 0.4, 0.9, 0.7, 0.2], dtype=np.float64)
PREC = 1.0 / Q ** 2 + 1.0 / R ** 2
F64 = torch.float64


def kalman_log_ml(ys):
    """Exact log p(y_1:T) of the scalar model (tests/test_batched_filter.py
    :54-66)."""
    mu, var, total = 0.0, 1.0, 0.0
    for i, y in enumerate(ys):
        if i > 0:
            mu, var = A * mu, A * A * var + Q * Q
        s = var + R * R
        total += -0.5 * (np.log(2 * np.pi * s) + (y - mu) ** 2 / s)
        k = var / s
        mu, var = mu + k * (y - mu), (1 - k) * var
    return total


# --- the models in both DSLs -----------------------------------------------

def _models(dist, sqrt, softplus, plate_of):
    def init(h, _s0):
        x = h.sample(dist, (0.0, 1.0), "x")
        h.sample(dist, (x, R), "y")
        return x

    def step(h, t, prev):
        x = h.sample(dist, (A * prev, Q), "x")
        h.sample(dist, (x, R), "y")
        return x

    def prop(h, t, prev, cons):
        y = cons.read("y")
        m = (A * prev / Q ** 2 + y / R ** 2) / PREC
        h.sample(dist, (m, 1.0 / sqrt(PREC)), "x")

    def learnable(h, t, prev, cons, params):
        y = cons.read("y")
        m = params["w_prev"] * prev + params["w_obs"] * y + params["bias"]
        h.sample(dist, (m, softplus(params["raw_std"])), "x")

    def init_batched(h, _s0, n):
        x = h.sample(plate_of(dist, n), (0.0, 1.0), "x")
        h.sample(dist, (x, R), "y")
        return x

    def step_batched(h, t, prev):
        x = h.sample(plate_of(dist, prev.shape[0]), (A * prev, Q), "x")
        h.sample(dist, (x, R), "y")
        return x

    return {name: f for name, f in locals().items() if callable(f)
            and name not in ("dist", "sqrt", "softplus", "plate_of")}


PORT = {k: gen(f) for k, f in _models(normal, math.sqrt,
                                      torch.nn.functional.softplus,
                                      plate).items()}
REF = {k: jgen(f) for k, f in _models(j_normal, jnp.sqrt, jax.nn.softplus,
                                      j_plate).items()}
J_KERNEL = JScanKernel(REF["init"], REF["step"])
J_BATCHED = JScanKernel(REF["init_batched"], REF["step_batched"])


def _params(lib):
    vals = {"w_prev": A / Q ** 2 / PREC, "w_obs": 1.0 / R ** 2 / PREC,
            "bias": 0.0, "raw_std": float(np.log(np.expm1(1 / np.sqrt(PREC))))}
    if lib == "jax":
        return {k: jnp.asarray(v) for k, v in vals.items()}
    return {k: torch.tensor(v, dtype=F64) for k, v in vals.items()}


def _jax_constraints():
    init_c = JTrie.from_dict({"y": jnp.asarray(YS[0])})
    step_c = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[JTrie.from_dict({"y": jnp.asarray(y)}) for y in YS[1:]])
    return init_c, step_c


def _port_constraints(ys=YS):
    return (Trie.from_dict({"y": torch.tensor(ys[0], dtype=F64)}),
            Trie.from_dict({"y": torch.tensor(ys[1:], dtype=F64)}))


# --- the reference's draws, rebuilt from its key chain ---------------------

def _lanes(key, addr, n):
    """The per-particle draws of a site whose params are per particle: one
    stream a lane, fold_in(addr_subkey(key, addr), i)
    (modeling/autobatch.py:90-91), as Standard normals."""
    z = jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(addr_subkey(key, addr), i), (), jnp.float64))(
        jnp.arange(n))
    return Standard(tensor(np.asarray(z)))


def _moves(k_rej, n, num_moves):
    """vsmc._rejuvenate's draws (vsmc.py:136-150): one key a particle, move
    r from fold_in(key_i, r), split into the regenerate's and the accept's."""
    keys = jax.random.split(k_rej, n)
    out = []
    for r in range(num_moves):
        ks = jax.vmap(lambda k: jax.random.split(jax.random.fold_in(k, r)))(
            keys)
        z = jax.vmap(lambda k: jax.random.normal(addr_subkey(k, "x"), (),
                                                 jnp.float64))(ks[:, 0])
        u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(
            ks[:, 1])
        out.append(({"x": Standard(tensor(np.asarray(z)))},
                    tensor(np.asarray(u))))
    return out


def _reference_draws(seed, n, sharded, proposal=False, num_moves=0,
                     batch_aware=False):
    """The reference filter's randoms as the port's replay entries:
    batched_smc_init's plate, then per step the key split of
    sharded_smc.py:431 (4 ways) or vsmc.py:239-241 (3 ways, the moves'
    key fold_in(key, 3)), the resample uniform, the model's or the
    proposal's per-particle draws, and each move's."""
    k_gen, key = jax.random.split(jax.random.PRNGKey(seed))
    x0 = j_normal.sample_batch(addr_subkey(k_gen, "x"), (n,), (0.0, 1.0))
    replay = [(None, {"x": tensor(np.asarray(x0))})]
    for _ in range(len(YS) - 1):
        if sharded:
            carry, k_res, k_gen, k_rej = jax.random.split(key, 4)
            u = jax.random.uniform(jax.random.fold_in(k_res, 0), (),
                                   jnp.float64)
        else:
            carry, k_res, k_gen = jax.random.split(key, 3)
            k_rej = jax.random.fold_in(key, 3)
            u = jax.random.uniform(k_res, (), jnp.float64)
        key = carry
        if batch_aware:
            z = jax.random.normal(addr_subkey(k_gen, "x"), (n,), jnp.float64)
            pool = {"x": Standard(tensor(np.asarray(z)))}
        else:
            pool = {} if proposal else {"x": _lanes(k_gen, "x", n)}
        u = tensor(np.asarray(u))
        if not proposal and not num_moves:
            replay.append((u, pool))
            continue
        prop_pool = ({"x": _lanes(jax.random.split(k_gen)[0], "x", n)}
                     if proposal else None)
        replay.append((u, pool, prop_pool, _moves(k_rej, n, num_moves)))
    return replay


def _run(sharded, lib, key, n, **kw):
    if lib == "jax":
        init_c, step_c = _jax_constraints()
        kernel = J_BATCHED if kw.pop("batch_aware", False) else J_KERNEL
        args = (key, kernel, jnp.zeros(()), init_c, step_c, n)
        return (j_sharded(None, *args, ess_threshold=1.0, **kw) if sharded
                else j_vsmc(*args, ess_threshold=1.0, **kw))
    init_c, step_c = _port_constraints()
    kernel = (ScanKernel(PORT["init_batched"], PORT["step_batched"])
              if kw.pop("batch_aware", False)
              else ScanKernel(PORT["init"], PORT["step"]))
    args = (key, kernel, torch.zeros((), dtype=F64), init_c, step_c, n)
    if sharded:
        return sharded_batched_particle_filter(None, *args, device="cpu", **kw)
    return batched_particle_filter(*args, device="cpu", **kw)


def _hold(got, want):
    np.testing.assert_array_equal(got["ancestors"].numpy(),
                                  np.asarray(want["ancestors"]))
    np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(got["ess"].numpy(), np.asarray(want["ess"]),
                               rtol=1e-9)
    np.testing.assert_allclose(float(got["log_ml"]), float(want["log_ml"]),
                               rtol=1e-9)


MODES = {"guided": dict(proposal=True, num_moves=0),
         "rejuvenated": dict(proposal=False, num_moves=2),
         "guided+rejuvenated": dict(proposal=True, num_moves=1)}


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "vsmc"])
@pytest.mark.parametrize("mode", list(MODES))
def test_filter_replayed_matches_reference(sharded, mode):
    """Both entry points, each mode, on the reference's draws."""
    n, seed = 1024, 4
    cfg = MODES[mode]
    kw = {"auto_batch": True}
    if cfg["proposal"]:
        kw["proposal"] = "prop"
    if cfg["num_moves"]:
        kw["rejuvenation"] = ("x", cfg["num_moves"])

    def with_lib(lib):
        out = dict(kw)
        if "proposal" in out:
            out["proposal"] = (REF if lib == "jax" else PORT)["prop"]
        if "rejuvenation" in out:
            out["rejuvenation"] = ((jselect if lib == "jax" else select)("x"),
                                   cfg["num_moves"])
        return out

    want = _run(sharded, "jax", jax.random.PRNGKey(seed), n, **with_lib("jax"))
    replay = _reference_draws(seed, n, sharded, **cfg)
    got = _run(sharded, "torch", 77, n, replay=replay, **with_lib("torch"))
    _hold(got, want)
    if cfg["num_moves"]:
        acc = got["acceptance"]
        assert acc.shape == (len(YS) - 1, cfg["num_moves"])
        assert 0.0 < float(acc.mean()) < 1.0


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "vsmc"])
def test_batch_aware_plate_kernel_matches_reference(sharded):
    """auto_batch=False: a batch-aware kernel with plate sites, the plates'
    reference draws injected."""
    n, seed = 1024, 9
    want = _run(sharded, "jax", jax.random.PRNGKey(seed), n,
                batch_aware=True)
    got = _run(sharded, "torch", 0, n, batch_aware=True,
               replay=_reference_draws(seed, n, sharded, batch_aware=True))
    _hold(got, want)
    assert got["acceptance"] is None


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "vsmc"])
def test_proposal_params_matches_reference(sharded):
    """proposal_params, as a dict of tensors, reaches the proposal."""
    n, seed = 1024, 2
    want = _run(sharded, "jax", jax.random.PRNGKey(seed), n, auto_batch=True,
                proposal=REF["learnable"], proposal_params=_params("jax"))
    got = _run(sharded, "torch", 5, n, auto_batch=True,
               proposal=PORT["learnable"], proposal_params=_params("torch"),
               replay=_reference_draws(seed, n, sharded, proposal=True))
    _hold(got, want)


def test_guided_requires_auto_batch():
    """tests/test_batched_filter.py::test_batched_guided_requires_auto_batch
    on both entry points: a batch-aware kernel takes no proposal and no
    rejuvenation."""
    for sharded in (True, False):
        for kw in ({"proposal": PORT["prop"]},
                   {"rejuvenation": (select("x"), 1)}):
            with pytest.raises(ValueError, match="auto_batch"):
                _run(sharded, "torch", 0, 512, batch_aware=True, **kw)


def test_rejuvenation_selection_outside_the_trace_raises():
    with pytest.raises(ValueError, match="not in the step kernel's trace"):
        _run(True, "torch", 0, 512, auto_batch=True,
             rejuvenation=(select("z"), 1))


# --- the reference's statistical gates, on the port's streams --------------

@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "vsmc"])
def test_guided_gates(sharded):
    """tests/test_batched_filter.py:186-225: the locally optimal proposal's
    log-ML within 0.05 of Kalman over six seeds, its ESS above the bootstrap
    filter's at every seed; and with the optimal proposal's parameters as
    proposal_params, within 0.05 over three."""
    want = kalman_log_ml(YS)
    guided = []
    for seed in range(6):
        g = _run(sharded, "torch", seed, 2048, auto_batch=True,
                 proposal=PORT["prop"])
        b = _run(sharded, "torch", seed, 2048, auto_batch=True)
        guided.append(float(g["log_ml"]))
        assert float(g["ess"].mean()) > float(b["ess"].mean())
    assert np.mean(guided) == pytest.approx(want, abs=0.05)
    learned = [float(_run(sharded, "torch", 10 + s, 4096, auto_batch=True,
                          proposal=PORT["learnable"],
                          proposal_params=_params("torch"))["log_ml"])
               for s in range(3)]
    assert np.mean(learned) == pytest.approx(want, abs=0.05)


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "vsmc"])
def test_rejuvenation_gate(sharded):
    """tests/test_batched_filter.py:228-239: two moves a step leave the
    log-ML unbiased, within 0.08 of Kalman (the mean of four seeds at
    N = 4096: one seed's Monte Carlo spread on the port's streams is close
    to the reference's one-seed gate), and the moves run."""
    lml = []
    for seed in range(4):
        out = _run(sharded, "torch", seed, 4096, auto_batch=True,
                   rejuvenation=(select("x"), 2))
        lml.append(float(out["log_ml"]))
        assert 0.0 < float(out["acceptance"].mean()) < 1.0
    assert np.mean(lml) == pytest.approx(kalman_log_ml(YS), abs=0.08)


def test_moves_keep_logjp_equal_to_a_fresh_generate():
    """After every move the trace's logjp is that of a fresh generate of its
    own choices: a move leaves no stale log-probability behind."""
    kernel = auto_batch_scan_kernel(ScanKernel(PORT["init"], PORT["step"]))
    prev = torch.linspace(-1.0, 1.0, 512, dtype=F64)
    cons = Trie.from_dict({"y": torch.tensor(0.4, dtype=F64).expand(512)})
    trace, _ = kernel.step.generate(1, (1, prev), cons)
    for r in range(3):
        trace, accepts = _rejuvenate(100 + r, trace, kernel, select("x"), 1)
        fresh, _ = PORT["step"].generate(0, trace.args, trace.data)
        np.testing.assert_allclose(trace.logjp.numpy(), fresh.logjp.numpy(),
                                   rtol=1e-13)
        assert 0 < int(accepts[0].sum()) < 512


# --- the multivariate LGSSM ------------------------------------------------

def _kalman_mv(p, ys):
    """Exact log p(y_1:T) of the LGSSM, float64 numpy."""
    mu, P, total = p["mu0"], p["P0"], 0.0
    for i, y in enumerate(ys):
        if i > 0:
            mu, P = p["A"] @ mu, p["A"] @ P @ p["A"].T + p["Q"]
        S = p["H"] @ P @ p["H"].T + p["R"]
        r = y - p["H"] @ mu
        total += -0.5 * (len(y) * np.log(2 * np.pi) + np.linalg.slogdet(S)[1]
                         + r @ np.linalg.solve(S, r))
        K = P @ p["H"].T @ np.linalg.inv(S)
        mu, P = mu + K @ r, P - K @ p["H"] @ P
    return total


def test_lgssm_rejuvenated_filter_matches_kalman():
    """The LGSSM (through the reference's make_lgssm and interop) with one
    move a step over the latent, on both entry points, against the exact
    Kalman log-ML: the mean of three seeds at N = 2^15 (with a move after
    weighting, one seed's Monte Carlo spread at N = 4096 is wider than the
    gate)."""
    jp = jlgssm.make_lgssm(
        A=[[0.9, 0.1], [0.0, 0.8]], Q=[[0.3, 0.05], [0.05, 0.2]],
        H=[[1.0, 0.0], [0.5, 1.0]], R=[[0.25, 0.0], [0.0, 0.25]],
        mu0=[0.0, 0.0], P0=[[1.0, 0.0], [0.0, 1.0]])
    arrays = {k: np.array(getattr(jp, k))
              for k in ("A", "Q", "H", "R", "mu0", "P0")}
    params = lgssm_params_from_numpy(*arrays.values())
    for a, b in zip((make_lgssm(*arrays.values(), device="cpu").A, params.A),
                    (arrays["A"], arrays["A"])):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-7)
    _, ys = lgssm_simulate(3, params, 8)
    assert ys.shape == (8, 2) and ys.dtype == F64
    want = _kalman_mv(arrays, ys.numpy())
    kernel = lgssm_scan_kernel(params)
    init_c = Trie.from_dict({"obs": ys[0]})
    step_c = Trie.from_dict({"obs": ys[1:]})
    for f, extra in ((sharded_batched_particle_filter, (None,)),
                     (batched_particle_filter, ())):
        lml = [float(f(*extra, s, kernel, torch.zeros(2, dtype=F64), init_c,
                       step_c, 1 << 15, auto_batch=True,
                       rejuvenation=(select("x"), 1),
                       device="cpu")["log_ml"]) for s in range(3)]
        assert np.mean(lml) == pytest.approx(want, abs=0.1)


def test_filters_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """With no CUDA device both entry points raise by default, and run on
    the CPU with device="cpu", the inputs moved there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init_c, step_c = _port_constraints()
    kernel = ScanKernel(PORT["init"], PORT["step"])
    for f, extra in ((sharded_batched_particle_filter, (None,)),
                     (batched_particle_filter, ())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            f(*extra, 0, kernel, torch.zeros((), dtype=F64), init_c, step_c,
              256, auto_batch=True)
        out = f(*extra, 0, kernel, torch.zeros((), dtype=F64), init_c, step_c,
                256, auto_batch=True, device="cpu")
        assert out["state"].device.type == "cpu"
        assert math.isfinite(float(out["log_ml"]))


@pytest.mark.parametrize("mode", list(MODES))
def test_record_then_replay_is_identical(mode):
    """A run's recorded draws (the generate's, the proposal's, each move's
    and its accept uniforms) replay to the identical filter: the chip smoke
    test's rerun through the plain versions relies on this."""
    cfg = MODES[mode]
    kw = {"auto_batch": True}
    if cfg["proposal"]:
        kw["proposal"] = PORT["prop"]
    if cfg["num_moves"]:
        kw["rejuvenation"] = (select("x"), cfg["num_moves"])
    for sharded in (True, False):
        rec = []
        first = _run(sharded, "torch", 3, 1024, record=rec, **kw)
        again = _run(sharded, "torch", 99, 1024, replay=rec, **kw)
        assert len(rec) == len(YS)
        assert len(rec[1]) == 2 + 2 * (cfg["proposal"] or cfg["num_moves"] > 0)
        for what in ("state", "log_weights", "log_ml", "ancestors", "ess"):
            assert torch.equal(first[what], again[what]), what
