"""``mcmc_chains`` (inference/mcmc.py), port vs reference on the CPU.

C chains run as one batched trace, chain i keyed ``split(key, C)[i]`` by a
lane key. Parity: the reference's ``mcmc_chains`` and the port on the
reference's own draws (each chain's proposal normals at
``addr_subkey(k_fwd, "mu")`` and accept uniforms, split as
``modppl_tpu/inference/mcmc.py`` splits them): the chains equal to float64
rounding and the accepts exactly. Then ``tests/test_mcmc_compiled.py``'s
four gates at its sizes and bounds, and chain i's draws at C and 2C.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modppl_tpu import Trie as JTrie
from modppl_tpu import gen as jgen
from modppl_tpu import normal as jnormal
from modppl_tpu import select as jselect
from modppl_tpu.modeling.handlers import addr_subkey
from modppl_tpu_torch.core.address import select
from modppl_tpu_torch.core.keys import fold_in, split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import Standard, normal
from modppl_tpu_torch.inference.mcmc import (
    mcmc_chain,
    mcmc_chains,
    mh_kernel,
    regen_mh_kernel,
)
from modppl_tpu_torch.inference.mh import mh
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models.hmm import HMM
from _torch_threads import one_thread  # noqa: F401

jmcmc = importlib.import_module("modppl_tpu.inference.mcmc")

F64 = torch.float64


@jgen
def j_conjugate(h):
    mu = h.sample(jnormal, (0.0, 1.0), "mu")
    h.sample(jnormal, (mu, 1.0), "x")
    return mu


@jgen
def j_drift(h, trace, drift):
    h.sample(jnormal, (trace.data.read("mu"), drift), "mu")


@gen
def conjugate(h):
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")
    return mu


@gen
def drift_proposal(h, trace, drift):
    h.sample(normal, (trace.data.read("mu"), drift), "mu")


def _obs():
    return Trie.from_dict({"x": torch.tensor(1.0, dtype=F64)})


def _mu(trace):
    return trace.data.read("mu")


def _reference_draws(key, c, iters, regen):
    """Each chain's per-iteration (standard normal of "mu", accept
    uniform), keyed as the reference keys chain i's iteration t."""
    def one(k):
        if regen:
            k_prop, k_acc = jax.random.split(k)
        else:
            k_prop, _, _, k_acc = jax.random.split(k, 4)
        return (jax.random.normal(addr_subkey(k_prop, "mu"), (), jnp.float64),
                jax.random.uniform(k_acc, (), jnp.float64))

    keys = jax.vmap(lambda kc: jax.random.split(kc, iters))(
        jax.random.split(key, c))
    z, u = jax.vmap(jax.vmap(one))(keys)        # (C, T) each
    return [({"mu": Standard(tensor(np.asarray(z[:, t])))},
             tensor(np.asarray(u[:, t]))) for t in range(iters)]


@pytest.mark.parametrize("regen", [False, True], ids=["mh", "regen_mh"])
def test_mcmc_chains_matches_reference(regen):
    c, iters = 16, 60
    jobs = JTrie.from_dict({"x": 1.0})
    traces0, _ = jax.vmap(lambda k: j_conjugate.generate(k, (), jobs))(
        jax.random.split(jax.random.PRNGKey(2), c))
    if regen:
        jk, tk = (jmcmc.regen_mh_kernel(j_conjugate, jselect("mu")),
                  regen_mh_kernel(conjugate, select("mu")))
    else:
        jk, tk = (jmcmc.mh_kernel(j_conjugate, j_drift, (0.8,)),
                  mh_kernel(conjugate, drift_proposal, (0.8,)))
    key = jax.random.PRNGKey(3)
    _, want_mu, want_acc = jmcmc.mcmc_chains(key, jk, traces0, iters, c,
                                             extract=lambda t: t.data.read(
                                                 "mu"))
    t0, _ = conjugate.generate(split_keys(0, c, "cpu"), (), _obs(), pool={
        "mu": tensor(np.asarray(traces0.data.read("mu")))})
    final, mus, accepts = mcmc_chains(
        0, tk, t0, iters, c, extract=_mu,
        draws=_reference_draws(key, c, iters, regen))
    assert mus.shape == (c, iters) and accepts.shape == (c, iters)
    np.testing.assert_array_equal(accepts.numpy(), np.asarray(want_acc))
    np.testing.assert_allclose(mus.numpy(), np.asarray(want_mu), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(final.data.read("mu"), mus[:, -1], rtol=0,
                               atol=0)
    assert 0 < float(accepts.double().mean()) < 1


def test_chain_i_draws_the_same_at_c_and_2c():
    kernel = mh_kernel(conjugate, drift_proposal, (0.8,))
    outs = []
    for c in (24, 48):
        t0, _ = conjugate.generate(split_keys(4, c, "cpu"), (), _obs())
        outs.append(mcmc_chains(5, kernel, t0, 50, c, extract=_mu))
    (_, mus_c, acc_c), (_, mus_2c, acc_2c) = outs
    assert torch.equal(mus_2c[:24], mus_c)
    assert torch.equal(acc_2c[:24], acc_c)


def test_mcmc_chains_refuses_a_model_it_cannot_batch():
    params_like = [torch.tensor([0.5, 0.5]), torch.eye(2), torch.eye(2)]
    from modppl_tpu_torch.models.hmm import HMMParams

    kernel = mh_kernel(HMM(HMMParams(*params_like)), drift_proposal, (0.8,))
    with pytest.raises(TypeError, match="chain axis"):
        mcmc_chains(0, kernel, None, 3, 2)


# --------------------------------------------------------------------------
# tests/test_mcmc_compiled.py's gates, at its sizes and bounds
# --------------------------------------------------------------------------

def test_compiled_mh_single_chain():
    trace0, _ = conjugate.generate(0, (), _obs(), device="cpu")
    kernel = mh_kernel(conjugate, drift_proposal, (0.8,))
    _, mus, accepts = mcmc_chain(1, kernel, trace0, 5000, extract=_mu)
    mus = mus.numpy()[1000:]
    assert mus.mean() == pytest.approx(0.5, abs=0.06)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.06)
    assert 0.2 < float(accepts.double().mean()) < 0.95


def test_compiled_mh_many_chains():
    num_chains = 64
    traces0, _ = conjugate.generate(split_keys(2, num_chains, "cpu"), (),
                                    _obs())
    kernel = mh_kernel(conjugate, drift_proposal, (0.8,))
    _, mus, _ = mcmc_chains(3, kernel, traces0, 400, num_chains, extract=_mu)
    assert mus.shape == (num_chains, 400)
    pooled = mus[:, 100:].numpy().ravel()
    assert pooled.mean() == pytest.approx(0.5, abs=0.03)
    assert pooled.std() == pytest.approx(np.sqrt(0.5), abs=0.03)


def test_compiled_regen_mh():
    trace0, _ = conjugate.generate(4, (), _obs(), device="cpu")
    kernel = regen_mh_kernel(conjugate, select("mu"))
    _, mus, _ = mcmc_chain(5, kernel, trace0, 8000, extract=_mu)
    mus = mus.numpy()[1000:]
    assert mus.mean() == pytest.approx(0.5, abs=0.06)
    assert mus.std() == pytest.approx(np.sqrt(0.5), abs=0.06)


def test_compiled_matches_eager_distribution():
    trace, _ = conjugate.generate(6, (), _obs(), device="cpu")
    eager = []
    for i in range(1500):
        trace, _ = mh(fold_in(7, i), conjugate, trace, drift_proposal,
                      (0.8,))
        eager.append(float(trace.data.read("mu")))
    eager = np.array(eager[300:])
    trace0, _ = conjugate.generate(8, (), _obs(), device="cpu")
    kernel = mh_kernel(conjugate, drift_proposal, (0.8,))
    _, mus, _ = mcmc_chain(9, kernel, trace0, 1500, extract=_mu)
    compiled = mus.numpy()[300:]
    assert eager.mean() == pytest.approx(compiled.mean(), abs=0.15)
    assert eager.std() == pytest.approx(compiled.std(), abs=0.15)
