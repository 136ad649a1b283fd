"""NUTS on the reference's positive-support model from the reference's
start (the initial trace's point plus 0.5 standard normals a chain),
importance sampling over its lane draws (gamma's lane form), and a NaN
leaf counted as accepting nothing, on the CPU.

The model is tests/test_hmc_vi.py:28-32's ``normal_scale_model``; the gate
its :68-76 (the posterior mean within 0.08 of the quadrature oracle), at
fewer chains and iterations than chip_smoke.py's phase 37 runs on the
card (10^4 chains, 200 + 300)."""

import math

import numpy as np
import pytest
import torch

from modppl_tpu_torch.core.keys import split_keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists import gamma, iid, normal
from modppl_tpu_torch.inference.nuts import nuts_runner, nuts_transition
from modppl_tpu_torch.modeling import gen
from _torch_threads import one_thread  # noqa: F401

YS = (0.5, -1.2, 0.8, 2.0, -0.3)
ys5 = iid(normal, 5)


@gen
def normal_scale_model(h):
    scale = h.sample(gamma, (2.0, 1.0), "scale")
    h.sample(ys5, (0.0, scale), "ys")


def _oracle():
    grid = np.linspace(1e-3, 10.0, 4000)
    logp = (np.log(grid) - grid
            + sum(-0.5 * (y / grid) ** 2 - np.log(grid) for y in YS))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    return float((grid * w).sum())


def test_nuts_positive_support_from_prior_draws():
    """The chains start from the reference's jitter around the initial
    trace, itself a draw of the model given the observations."""
    obs = Trie.from_dict({"ys": torch.tensor(YS, dtype=torch.float64)})
    run = nuts_runner(normal_scale_model, (), obs, num_chains=64,
                      num_warmup=150, num_samples=150, max_depth=6,
                      device="cpu")
    out = run(0)
    scales = out["samples"]["scale"]
    assert scales.shape == (64, 150) and bool((scales > 0).all())
    assert float(scales.mean()) == pytest.approx(_oracle(), abs=0.08)
    assert float(out["divergences"].double().mean()) < 0.01


def test_prior_starts_are_lane_draws_resampled_by_weight():
    """Importance resampling over the model's lane draws (gamma's lane
    form): a lane's scale depends on its key alone (the first 100 lanes of
    500 are the 100-lane draw), every resampled index names a lane, and
    the resampled mean lies nearer the posterior mean than the draws'
    mean does."""
    from modppl_tpu_torch.core.keys import split
    from modppl_tpu_torch.inference.importance import (
        importance_resampling,
        importance_sampling,
    )

    obs = Trie.from_dict({"ys": torch.tensor(YS, dtype=torch.float64)})
    traces, idx, _ = importance_resampling(3, normal_scale_model, (), obs,
                                           500, 500, device="cpu")
    drawn = traces.data.read("scale")
    assert drawn.shape == (500,) and bool((drawn > 0).all())
    fewer, _, _ = importance_sampling(split(3)[0], normal_scale_model, (),
                                      obs, 100, device="cpu")
    assert torch.equal(fewer.data.read("scale"), drawn[:100])
    assert idx.shape == (500,) and bool(((idx >= 0) & (idx < 500)).all())
    picked = drawn[idx.long()].double()
    exact = _oracle()
    assert abs(float(picked.mean()) - exact) < abs(float(drawn.mean())
                                                   - exact)


def test_a_nan_leaf_accepts_nothing():
    """A leaf whose log-density is NaN (far out, where the model's terms
    give inf - inf) is divergent and adds 0 to the accept statistic: the
    reference's min(1, exp(logw)) is NaN there, and one NaN chain would
    make the pooled step size NaN for every chain."""

    def vag(u):
        lp = -0.5 * (u * u).sum(-1)
        lp = torch.where(u[:, 0].abs() > 3.0, torch.nan, lp)
        return lp, -u

    u = torch.tensor([[0.0], [2.9]], dtype=torch.float64)
    keys = split_keys(1, 2, "cpu")
    _, _, stats = nuts_transition(keys, u, vag, 5.0,
                                  torch.ones(1, dtype=torch.float64),
                                  max_depth=4)
    acc = stats["accept_prob"]
    assert bool(torch.isfinite(acc).all()) and bool((acc >= 0).all())
    assert bool(stats["divergent"].any())
    assert math.isfinite(float(acc.mean()))
