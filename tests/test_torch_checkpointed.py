"""Checkpoints and the checkpointed drivers (``utils/checkpoint.py``,
``inference/checkpointed.py``) on the CPU.

The round-trip gate of ``tests/test_checkpointed.py``: a run stopped at a
checkpoint and resumed by a fresh driver call with the full constraints is
bitwise the uninterrupted run, for the vmapped filter, the batched-tier
(sharded, one device) filter and the HMC runner at the reference test's
configurations. The checkpointed sharded filter is bitwise the one-shot
filter at the same key, as the checkpointed vmapped filter is
``particle_filter(store_traces=False)``; the vmapped one keeps the
reference's Kalman gate. Checkpoints keep the reference's layout: a dict
of arrays written by either package restores in the other.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.utils import checkpoint as jckpt
from modppl_tpu_torch.core.gfi import Trace
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import normal
from modppl_tpu_torch.inference.checkpointed import (
    checkpointed_hmc_runner,
    checkpointed_particle_filter,
    checkpointed_sharded_particle_filter,
)
from modppl_tpu_torch.interop import pooled_phase_draws, tensor
from modppl_tpu_torch.inference.vsmc import (
    ScanKernel,
    SMCState,
    particle_filter,
)
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models.spiral import spiral_scan_kernel
from modppl_tpu_torch.parallel.sharded_smc import (
    sharded_batched_particle_filter,
)
from modppl_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from _torch_threads import one_thread  # noqa: F401

F64 = torch.float64
A, Q, R = 0.9, 0.5, 0.3
YS = np.array([0.3, 0.5, 0.1, -0.2, 0.4, 0.9, 0.7, 0.2])


def _spiral_data(num_steps=9):
    obs = np.array([[0.4 * math.cos(2 * math.pi * t / 16),
                     0.4 * math.sin(2 * math.pi * t / 16)]
                    for t in range(num_steps)], np.float32)
    return (Trie.from_dict({"obs": torch.from_numpy(obs[0])}),
            Trie.from_dict({"obs": torch.from_numpy(obs[1:])}))


def _head(step_c, k):
    return step_c.map(lambda v: v[:k])


def _assert_same(a, b):
    for what in ("state", "log_weights", "log_ml"):
        assert torch.equal(a[what], b[what]), what


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


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")


# --------------------------------------------------------------------------
# utils/checkpoint.py
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_trace_and_metadata(tmp_path):
    """tests/test_aux_subsystems.py:58-74 in the port: a dict holding a
    Trace restores into another trace's structure, with its metadata."""
    trace = conjugate.simulate(3, (), device="cpu")
    state = {"trace": trace, "log_weights": torch.arange(8.0, dtype=F64),
             "step": torch.tensor(17)}
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state, step=17, metadata={"phase": "warmup"})
    example = {"trace": conjugate.simulate(4, (), device="cpu"),
               "log_weights": torch.zeros(8, dtype=F64),
               "step": torch.tensor(0)}
    restored, meta = restore_checkpoint(path, example)
    assert meta["step"] == 17 and meta["phase"] == "warmup"
    assert isinstance(restored["trace"], Trace)
    for addr in ("mu", "x"):
        assert torch.equal(restored["trace"].data.read(addr),
                           trace.data.read(addr))
        assert restored["trace"].data.search(addr).dist is normal
    assert torch.equal(restored["trace"].logjp, trace.logjp)
    assert torch.equal(restored["log_weights"], state["log_weights"])
    assert int(restored["step"]) == 17


def test_checkpoint_paths_and_count_are_checked(tmp_path):
    path = str(tmp_path / "c")
    save_checkpoint(path, {"a": torch.zeros(2), "b": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(path, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="'c'"):
        restore_checkpoint(path, {"a": torch.zeros(2), "c": torch.ones(3)})
    with pytest.raises(ValueError, match="example holds"):
        restore_checkpoint(path, {"a": torch.zeros(2, dtype=F64),
                                  "b": torch.ones(3)})


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"us": rng.standard_normal((4, 3)),
              "eps": np.asarray(0.25), "counts": np.arange(5, dtype=np.int64),
              "nested": {"w": rng.standard_normal(6).astype(np.float32)}}
    path = str(tmp_path / "ref")
    jckpt.save_checkpoint(path, {k: (jnp.asarray(v) if k != "nested" else
                                     {"w": jnp.asarray(v["w"])})
                                 for k, v in arrays.items()}, step=9)
    example = {"us": torch.zeros(4, 3, dtype=F64),
               "eps": torch.zeros((), dtype=F64),
               "counts": torch.zeros(5, dtype=torch.int64),
               "nested": {"w": torch.zeros(6)}}
    state, meta = restore_checkpoint(path, example)
    assert meta["step"] == 9
    assert torch.equal(state["us"], torch.from_numpy(arrays["us"]))
    assert float(state["eps"]) == 0.25
    assert torch.equal(state["counts"], torch.arange(5))
    assert torch.equal(state["nested"]["w"],
                       torch.from_numpy(arrays["nested"]["w"]))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    state = {"a": torch.from_numpy(rng.standard_normal((3, 2))),
             "b": {"c": torch.arange(4, dtype=torch.int64),
                   "d": torch.from_numpy(rng.standard_normal(5)
                                         .astype(np.float32))}}
    path = str(tmp_path / "port")
    save_checkpoint(path, state, step=4, metadata={"run": "x"})
    example = {"a": jnp.zeros((3, 2)), "b": {"c": jnp.zeros(4, jnp.int64),
                                             "d": jnp.zeros(5, jnp.float32)}}
    got, meta = jckpt.restore_checkpoint(path, example)
    assert meta == {"run": "x", "step": 4}
    np.testing.assert_array_equal(np.asarray(got["a"]), state["a"].numpy())
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]), np.arange(4))
    np.testing.assert_array_equal(np.asarray(got["b"]["d"]),
                                  state["b"]["d"].numpy())


def test_host_key_above_two_to_the_63_survives(tmp_path):
    key = (1 << 64) - 12345
    s = SMCState(key, torch.zeros(4, 2), torch.zeros(4), torch.zeros(()), 3)
    path = str(tmp_path / "k")
    save_checkpoint(path, s, step=2, key=key)
    example = SMCState(0, torch.ones(4, 2), torch.ones(4), torch.ones(()), 1)
    got, meta = restore_checkpoint(path, example)
    assert got.key == key and isinstance(got.key, int)
    assert got.t == 3 and meta["prng_key"] == key
    assert torch.equal(got.state, s.state)


def test_restore_onto_the_example_leafs_device(tmp_path):
    """Each leaf lands on its example leaf's device (here the meta device
    beside the CPU), never silently on the default one."""
    path = str(tmp_path / "d")
    save_checkpoint(path, {"x": torch.arange(6.0), "y": torch.ones(2)})
    got, _ = restore_checkpoint(path, {"x": torch.empty(6, device="meta"),
                                       "y": torch.zeros(2)})
    assert got["x"].device.type == "meta"
    assert got["y"].device.type == "cpu"
    assert torch.equal(got["y"], torch.ones(2))


def test_a_save_killed_mid_write_leaves_the_last_checkpoint(tmp_path,
                                                            monkeypatch):
    """Each file is written aside and renamed into place: a save that dies
    while writing the npz leaves the previous checkpoint whole."""
    from modppl_tpu_torch.utils import checkpoint as ckpt

    path = str(tmp_path / "w")
    save_checkpoint(path, {"x": torch.arange(4.0)}, step=1)

    def dies(f, **arrays):
        f.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.np, "savez", dies)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(path, {"x": torch.zeros(4)}, step=2)
    monkeypatch.undo()
    got, meta = restore_checkpoint(path, {"x": torch.empty(4)})
    assert meta["step"] == 1 and torch.equal(got["x"], torch.arange(4.0))


# --------------------------------------------------------------------------
# the checkpointed filters
# --------------------------------------------------------------------------

def _vmapped(path, step_c, resume_from=None, n=1024, key=5):
    init_c, _ = _spiral_data()
    return checkpointed_particle_filter(
        key, spiral_scan_kernel(), torch.zeros(2), init_c, step_c, n,
        checkpoint_path=path, checkpoint_every=3, resume_from=resume_from,
        device="cpu")


def test_vmapped_filter_resume_bitwise(tmp_path):
    init_c, step_c = _spiral_data()
    full = _vmapped(str(tmp_path / "full"), step_c)
    cut = str(tmp_path / "cut")
    _vmapped(cut, _head(step_c, 3))
    resumed = _vmapped(cut, step_c, resume_from=cut)
    _assert_same(resumed, full)
    assert full["t"] == resumed["t"] == 9
    one_shot = particle_filter(5, spiral_scan_kernel(), torch.zeros(2),
                               init_c, step_c, 1024, store_traces=False,
                               device="cpu")
    _assert_same(full, one_shot)


def _sharded(path, step_c, resume_from=None, every=3):
    init_c, _ = _spiral_data()
    return checkpointed_sharded_particle_filter(
        None, 11, spiral_scan_kernel(), torch.zeros(2), init_c, step_c,
        1024, checkpoint_path=path, checkpoint_every=every,
        resume_from=resume_from, auto_batch=True, device="cpu")


def test_sharded_filter_resume_bitwise_and_the_one_shot(tmp_path):
    init_c, step_c = _spiral_data()
    full = _sharded(str(tmp_path / "full"), step_c)
    cut = str(tmp_path / "cut")
    _sharded(cut, _head(step_c, 3))
    resumed = _sharded(cut, step_c, resume_from=cut)
    _assert_same(resumed, full)
    one_shot = sharded_batched_particle_filter(
        None, 11, spiral_scan_kernel(), torch.zeros(2), init_c, step_c, 1024,
        ess_threshold=1.0, auto_batch=True, device="cpu")
    _assert_same(full, one_shot)
    # another chunking replays the same steps
    _assert_same(_sharded(str(tmp_path / "four"), step_c, every=4), full)


def test_checkpointed_filters_refuse_a_mesh(tmp_path):
    """Anything but a ``parallel.mesh.Mesh`` (or None) is refused; a mesh of
    this one process runs the one-device filter, bitwise (the multi-shard
    runs are tests/test_torch_sharded_batched.py's)."""
    from modppl_tpu_torch.parallel.mesh import make_mesh

    init_c, step_c = _spiral_data()
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        checkpointed_sharded_particle_filter(
            object(), 0, spiral_scan_kernel(), torch.zeros(2), init_c,
            step_c, 1024, checkpoint_path=str(tmp_path / "m"),
            checkpoint_every=3, device="cpu")
    one, none = (checkpointed_sharded_particle_filter(
        mesh, 0, spiral_scan_kernel(), torch.zeros(2), init_c, step_c, 1024,
        checkpoint_path=str(tmp_path / tag), checkpoint_every=3,
        auto_batch=True, device="cpu")
        for mesh, tag in ((make_mesh(), "one"), (None, "none")))
    _assert_same(one, none)


def test_vmapped_checkpointed_filter_matches_kalman(tmp_path):
    """tests/test_checkpointed.py:65-75: the chunked filter keeps the
    Kalman gate (0.08) at 4096 particles, a checkpoint every 2 steps."""
    init_c = Trie.from_dict({"y": torch.tensor(YS[0])})
    step_c = Trie.from_dict({"y": torch.tensor(YS[1:])})
    out = checkpointed_particle_filter(
        0, ScanKernel(lg_init, lg_step), torch.zeros((), dtype=F64), init_c,
        step_c, 4096, checkpoint_path=str(tmp_path / "k"),
        checkpoint_every=2, device="cpu")
    assert abs(float(out["log_ml"]) - kalman_log_ml(YS)) < 0.08


# --------------------------------------------------------------------------
# the checkpointed HMC runner
# --------------------------------------------------------------------------

def _hmc_runner(path, num_samples):
    obs = Trie.from_dict({"x": torch.tensor(1.0, dtype=F64)})
    return checkpointed_hmc_runner(
        conjugate, (), obs, checkpoint_path=path, checkpoint_every=4,
        num_samples=num_samples, num_warmup=25, num_chains=4,
        num_leapfrog=3, setup_key=1, device="cpu")


def test_hmc_checkpoint_resume_bitwise(tmp_path):
    """tests/test_checkpointed.py:77-117 at its configuration: 4 samples,
    then a resume to 10, concatenated, are the uninterrupted run."""
    full = _hmc_runner(str(tmp_path / "full"), 10)(2)
    cut = str(tmp_path / "cut")
    head = _hmc_runner(cut, 4)(2)
    tail = _hmc_runner(cut, 10)(2, resume_from=cut)
    for what in ("unconstrained", "accept_prob", "logp"):
        got = torch.cat([head[what], tail[what]], dim=1)
        assert torch.equal(got, full[what]), what
    assert torch.equal(tail["step_size"], full["step_size"])
    assert torch.equal(tail["inv_mass"], full["inv_mass"])
    assert full["unconstrained"].shape == (4, 10, 1)
    assert full["samples"]["mu"].shape == (4, 10)


def _reference_hmc_draws(k_run, num_chains, dim, num_warmup, num_samples):
    """The reference runner's per-iteration draws, one (z (T, C, d), jit
    (T, C), u01 (T, C)) per phase: warmup phase p's iteration keys split
    fold_in(fold_in(key, 0), p), sample i's key fold_in(fold_in(key, 2), i)
    (key = fold_in(k_run, 0)), chain c's fold_in(of that, c), each drawn as
    the reference's hmc_transition draws from split(key, 3)."""
    import jax

    from modppl_tpu.inference import adaptation as jad

    def chain(k):
        k_mom, k_acc, k_jit = jax.random.split(k, 3)
        return (jax.random.normal(k_mom, (dim,), jnp.float64),
                jax.random.uniform(k_jit, (), minval=0.5, maxval=1.5),
                jax.random.uniform(k_acc, ()))

    def iteration(k):
        return jax.vmap(lambda c: chain(jax.random.fold_in(k, c)))(
            jnp.arange(num_chains))

    key = jax.random.fold_in(k_run, 0)
    fast1, slow, fast2 = jad.warmup_schedule(num_warmup)
    lengths = [n for n in (fast1, *slow, fast2) if n > 0]
    k_warm = jax.random.fold_in(key, 0)
    phases = [jax.vmap(iteration)(jax.random.split(
        jax.random.fold_in(k_warm, p), length))
        for p, length in enumerate(lengths)]
    base = jax.random.fold_in(key, 2)
    phases.append(jax.vmap(lambda i: iteration(jax.random.fold_in(base, i)))(
        jnp.arange(num_samples)))
    return [pooled_phase_draws([ph]) for ph in phases]


def test_hmc_resume_refuses_a_step_that_is_not_its_carrys(tmp_path):
    """A kill between the npz's rename and the json's leaves a new carry
    beside the old step: the runner's restore reads its sample count from
    the carry and refuses the mismatch, as the filters' restores do."""
    cut = str(tmp_path / "cut")
    _hmc_runner(cut, 4)(2)
    with open(cut + ".json", "w") as f:
        f.write('{"step": 0}')
    with pytest.raises(ValueError, match="step 0 but its carry has 4"):
        _hmc_runner(cut, 10)(2, resume_from=cut)


def test_hmc_runner_matches_reference_on_its_draws(tmp_path):
    """The runner at the reference test's configuration (4 chains, 25
    warmup + 10 samples, L = 3, a checkpoint every 4), fed the reference's
    start points and per-iteration draws, holds to
    ``modppl_tpu.inference.checkpointed.checkpointed_hmc_runner`` at 1e-10
    in float64: positions, logp, accept probabilities, divergences and the
    adapted step size; the inverse mass against the reference's
    ``run_warmup_pooled`` at the same start."""
    import jax
    from jax.flatten_util import ravel_pytree

    from modppl_tpu import Trie as JTrie
    from modppl_tpu import gen as jgen
    from modppl_tpu import normal as j_normal
    from modppl_tpu.inference import adaptation as jad
    from modppl_tpu.inference.checkpointed import (
        checkpointed_hmc_runner as j_runner,
    )

    jhmc = importlib.import_module("modppl_tpu.inference.hmc")

    @jgen
    def j_conjugate(h):
        mu = h.sample(j_normal, (0.0, 1.0), "mu")
        h.sample(j_normal, (mu, 1.0), "x")

    c, num_warmup, num_samples, leapfrog = 4, 25, 10, 3
    j_obs = JTrie.from_dict({"x": 1.0})
    k_setup, k_run = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    want = j_runner(j_conjugate, (), j_obs,
                    checkpoint_path=str(tmp_path / "ref"),
                    checkpoint_every=4, num_samples=num_samples,
                    num_warmup=num_warmup, num_chains=c,
                    num_leapfrog=leapfrog, setup_key=k_setup)(k_run)

    # the reference's start points, and its warmup alone for inv_mass
    tr, _ = j_conjugate.generate(k_setup, (), j_obs)
    lp, u0, _, _ = jhmc.make_unconstrained_logprob(j_conjugate, (), tr,
                                                   j_obs)
    u0_flat, unravel = ravel_pytree(u0)
    jitter = jax.vmap(lambda k: 0.5 * jax.random.normal(
        k, u0_flat.shape, u0_flat.dtype))(jax.random.split(k_run, c))
    u0s = u0_flat[None, :] + jitter

    def lp_flat(u):
        return lp(unravel(u))

    def warm_transition(k, u, eps, inv_mass):
        u, _, aprob, _ = jhmc.hmc_transition(k, u, lp_flat,
                                             jax.grad(lp_flat), eps,
                                             leapfrog, inv_mass)
        return u, aprob

    _, _, want_inv_mass = jad.run_warmup_pooled(
        jax.random.fold_in(jax.random.fold_in(k_run, 0), 0), u0s,
        warm_transition, num_warmup, 0.1, 0.8)

    draws = _reference_hmc_draws(k_run, c, 1, num_warmup, num_samples)
    run = _hmc_runner(str(tmp_path / "port"), num_samples)
    got = run(2, draws=draws, u0s=tensor(u0s))
    for what in ("unconstrained", "logp", "accept_prob", "step_size"):
        np.testing.assert_allclose(got[what].numpy(), np.asarray(want[what]),
                                   rtol=1e-10, atol=1e-10, err_msg=what)
    np.testing.assert_array_equal(got["divergences"].numpy(),
                                  np.asarray(want["divergences"]))
    np.testing.assert_allclose(got["inv_mass"].numpy(),
                               np.asarray(want_inv_mass), rtol=1e-10,
                               atol=1e-10)
    # a resumed run on the same draws replays the same tail
    cut = str(tmp_path / "cut")
    _hmc_runner(cut, 4)(2, draws=draws[:-1] + [
        tuple(a[:4] for a in draws[-1])], u0s=tensor(u0s))
    tail = _hmc_runner(cut, num_samples)(2, resume_from=cut, draws=draws)
    assert torch.equal(tail["unconstrained"], got["unconstrained"][:, 4:])


def test_hmc_chains_do_not_depend_on_the_chain_count(tmp_path):
    """Sampling keys by index and chains by lane: at a fixed (eps,
    inv_mass), chain c's draws are the same among 4 or 6 chains."""
    from modppl_tpu_torch.inference import checkpointed as ck

    z4, j4, u4 = ck._lane_draws(7, 4, 3, F64, "cpu")
    z6, j6, u6 = ck._lane_draws(7, 6, 3, F64, "cpu")
    assert torch.equal(z4, z6[:4]) and torch.equal(j4, j6[:4])
    assert torch.equal(u4, u6[:4])
    assert bool(((j6 >= 0.5) & (j6 < 1.5)).all())
