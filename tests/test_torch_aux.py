"""Diagnostics, profiling hooks, the exports and the time-parallel HMM
forward algorithm of the port, against the JAX package on the CPU.

``summarize_mcmc`` / ``summarize_smc`` take the same numpy output dicts on
both sides and agree at 1e-10; ``MetricsLogger`` writes the same lines
(all but the wall time); ``compiled_cost`` counts the reference's flops for
``x @ x``; the prelude and the packages export every name of the
reference's ``__all__`` lists (``torch`` for ``jax`` and ``jnp``);
``hmm_forward_log_ml_parallel`` equals the reference's and the port's
sequential forward at 1e-9 in float64.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu.models import hmm as jhmm
from modppl_tpu.utils import diagnostics as jdiag
from modppl_tpu.utils import profiling as jprof
from modppl_tpu_torch.models.hmm import (
    hmm_forward_log_ml,
    hmm_forward_log_ml_parallel,
)
from modppl_tpu_torch.utils import diagnostics, profiling
from _torch_threads import one_thread  # noqa: F401


def _mcmc_output(seed):
    rng = np.random.default_rng(seed)
    return {"samples": {"mu": rng.standard_normal((4, 200)),
                        "coeffs": rng.standard_normal((4, 200, 3)) + 1.0},
            "accept_prob": rng.random((4, 200)),
            "divergences": rng.random((4, 200)) < 0.01,
            "step_size": np.asarray(0.3)}


def _close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("as_tensors", [False, True])
def test_summarize_mcmc_matches_reference(as_tensors):
    out = _mcmc_output(0)
    want = jdiag.summarize_mcmc(out)
    if as_tensors:
        out = {"samples": {k: torch.from_numpy(v)
                           for k, v in out["samples"].items()},
               **{k: torch.from_numpy(np.asarray(v)) for k, v in out.items()
                  if k != "samples"}}
    got = diagnostics.summarize_mcmc(out)
    _close(got, want)
    assert "coeffs[2]" in got
    sub = diagnostics.summarize_mcmc(out, param_names=("mu",))
    _close(sub, jdiag.summarize_mcmc(_mcmc_output(0), param_names=("mu",)))


def test_summarize_smc_matches_reference():
    rng = np.random.default_rng(1)
    out = {"log_ml": np.asarray(-12.5), "ess": rng.random(9) * 1000,
           "resampled": rng.random(9) < 0.5,
           "log_weights": rng.standard_normal(1000)}
    want = jdiag.summarize_smc(out)
    _close(diagnostics.summarize_smc(out), want)
    _close(diagnostics.summarize_smc(
        {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}), want)


def test_metrics_logger_writes_the_reference_lines(tmp_path):
    lines = {}
    for name, mod in (("port", diagnostics), ("ref", jdiag)):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.MetricsLogger(path) as ml:
            ml.log(0, ess=123.4, log_ml=-5.6, tag="warm")
            ml.log(1, ess=(torch.tensor(120.0) if name == "port"
                           else jnp.asarray(120.0)), log_ml=-5.5)
        lines[name] = [json.loads(x) for x in open(path)]
    for got, want in zip(lines["port"], lines["ref"]):
        assert got.pop("time") > 0 and want.pop("time") > 0
        assert got == want
    assert len(lines["port"]) == 2


def test_profiling_hooks(tmp_path):
    """tests/test_aux_subsystems.py:95-110 in the port, and the flop count
    of x @ x at 16 x 16 equal to XLA's cost analysis (8192)."""
    x = torch.arange(64.0)
    with profiling.annotate("test.phase"):
        r, secs = profiling.device_time(lambda v: torch.sum(v * v), x)
    assert float(r) == float(torch.sum(x * x)) and secs > 0.0
    want = jprof.compiled_cost(lambda a: a @ a, jnp.ones((16, 16)))["flops"]
    got = profiling.compiled_cost(lambda a: a @ a, torch.ones(16, 16))
    assert got == {"flops": want} and want == 8192.0
    assert "add" in profiling.hlo_text(lambda v: v + 1.0, x)
    with profiling.capture_trace(str(tmp_path / "trace")) as prof:
        torch.sum(x * x)
    assert prof is not None and (tmp_path / "trace" / "trace.json").exists()


def test_exports_hold_every_name_of_the_reference():
    import modppl_tpu
    import modppl_tpu.inference
    import modppl_tpu.modeling
    import modppl_tpu.models
    import modppl_tpu.prelude
    import modppl_tpu.utils
    import modppl_tpu_torch
    import modppl_tpu_torch.inference
    import modppl_tpu_torch.modeling
    import modppl_tpu_torch.models
    import modppl_tpu_torch.prelude
    import modppl_tpu_torch.utils

    pairs = ((modppl_tpu, modppl_tpu_torch),
             (modppl_tpu.prelude, modppl_tpu_torch.prelude),
             (modppl_tpu.inference, modppl_tpu_torch.inference),
             (modppl_tpu.models, modppl_tpu_torch.models),
             (modppl_tpu.modeling, modppl_tpu_torch.modeling),
             (modppl_tpu.utils, modppl_tpu_torch.utils))
    for ref, port in pairs:
        missing = [n for n in ref.__all__ if n not in ("jax", "jnp")
                   and n not in port.__all__]
        assert not missing, (port.__name__, missing)
        for n in port.__all__:
            assert getattr(port, n) is not None
    assert modppl_tpu_torch.prelude.torch is torch
    p = modppl_tpu_torch.prelude
    assert callable(p.mh) and callable(p.nuts) and callable(p.particle_filter)


def _hmm_case(k, t, seed):
    rng = np.random.default_rng(1000 * k + t + seed)
    prior = rng.dirichlet(np.ones(k))
    emission = rng.dirichlet(np.ones(3), size=k).T      # [obs, state]
    transition = rng.dirichlet(np.ones(k), size=k).T    # [new, prev]
    return prior, emission, transition, rng.integers(0, 3, t)


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("t", [1, 2, 7, 64, 257])
def test_hmm_forward_parallel_matches_reference_and_sequential(k, t):
    prior, emission, transition, obs = _hmm_case(k, t, 0)
    got = float(hmm_forward_log_ml_parallel(
        torch.from_numpy(prior), torch.from_numpy(emission),
        torch.from_numpy(transition), torch.from_numpy(obs), device="cpu"))
    ref = float(jhmm.hmm_forward_log_ml_parallel(prior, emission, transition,
                                                 obs))
    seq = float(hmm_forward_log_ml(prior, emission, transition, obs))
    assert got == pytest.approx(ref, abs=1e-9)
    assert got == pytest.approx(seq, abs=1e-9)
