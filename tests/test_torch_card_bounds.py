"""The reference behind two of ``chip_smoke.py``'s card gates (CPU).

Each gate of phases 20 and 21 whose bound comes from the JAX package's own
behaviour at the leg's full size is recomputed here, with the reference at
that size on the CPU in float64:

- phase 21 holds ADVI's mu within ``VI_MU_BOUND`` of the importance-
  sampling oracle's posterior mean: twice the reference's own largest
  coordinate distance (bench_vi's configuration and data, key PRNGKey(0));
- phase 20 holds ChEES's accept rate within ``CHEES_ACCEPT_GAP`` of
  ``CHEES_REF_ACCEPT``, the reference's rate at bench_chees's configuration
  (key PRNGKey(0): 0.910). Its adaptation targets 0.75, but its short
  last step-size window leaves the sampling phase well above that, so a
  band around 0.75 would reject the reference itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from modppl_tpu import Trie as JTrie
from modppl_tpu.inference.chees import chees_runner
from modppl_tpu.inference.vi import advi
from modppl_tpu.models import logreg as jlr
from modppl_tpu.models.hierarchical_static import make_hierarchical_static
from _torch_threads import one_thread  # noqa: F401


def test_vi_leg_bound():
    X, ys, _ = jlr.simulate_logreg(jax.random.PRNGKey(7), cs.VI["n_data"],
                                   cs.VI["dim"])
    X, ys = np.asarray(X, np.float32), np.asarray(ys, np.float32)
    oracle = cs.logreg_oracle(X, ys, draws=200_000)[0]
    out = advi(jax.random.PRNGKey(0), jlr.make_logreg(cs.VI["dim"]),
               (jnp.asarray(X), jnp.asarray(ys)), JTrie(),
               num_steps=cs.VI["num_steps"], num_mc=cs.VI["num_mc"],
               learning_rate=cs.VI["learning_rate"])
    dist = float(np.abs(np.asarray(out["mu"]) - oracle).max())
    assert cs.VI_MU_BOUND == pytest.approx(max(0.05, 2.0 * dist), abs=2e-3)


def test_chees_leg_accept_reference():
    xs, ys = (x.numpy() for x in cs.hierarchical_data("cpu"))
    run = chees_runner(make_hierarchical_static(10), (jnp.asarray(xs),),
                       JTrie.from_dict({"ys": jnp.asarray(ys),
                                        "is_linear": False}),
                       setup_key=jax.random.PRNGKey(99), **cs.CHEES)
    out = run(jax.random.PRNGKey(0))
    accept = float(jnp.mean(out["accept_prob"]))
    assert cs.CHEES_REF_ACCEPT == pytest.approx(accept, abs=2e-3)
