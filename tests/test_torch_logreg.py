"""The non-quadratic targets on the port's generic HMC path (CPU).

Counterparts of tests/test_logreg.py (detection refuses the logistic
regression; the generic pooled path recovers the posterior around the MAP)
and of tests/test_factor_marginalized.py:63-89 (HMC on the gate-marginalized
hierarchical model against the exact conjugate mixture), with the
reference's bounds. The data come from the port's own generator
(``simulate_logreg``), not the reference's threefry draws.
"""

import numpy as np
import pytest
import torch

from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.hmc import (
    detect_quadratic_target,
    hmc,
    make_unconstrained_logprob,
    ravel_latents,
)
from modppl_tpu_torch.interop import tensor
from modppl_tpu_torch.models.hierarchical_static import (
    exact_hierarchical_posterior,
    make_hierarchical_marginalized,
)
from modppl_tpu_torch.models.logreg import (
    make_logreg,
    map_newton,
    simulate_logreg,
)
from _torch_threads import one_thread  # noqa: F401


def test_logreg_is_not_quadratic():
    d = 3
    X, ys, _ = simulate_logreg(0, 64, d, device="cpu")
    model = make_logreg(d)
    tr, _ = model.generate(1, (X, ys), Trie())
    logprob, u0, _, _ = make_unconstrained_logprob(model, (X, ys), tr,
                                                   Trie(), device="cpu")
    u0f, unravel = ravel_latents(u0)
    assert detect_quadratic_target(lambda u: logprob(unravel(u)),
                                   u0f.shape[0], u0f.dtype,
                                   device="cpu") is None


def test_logreg_hmc_posterior_near_map():
    """test_logreg.py:32-48, as there: 16 chains, 200 + 300, L = 8."""
    d, n = 2, 400
    X, ys, _ = simulate_logreg(2, n, d, w_true=[1.0, -1.0], device="cpu")
    out = hmc(3, make_logreg(d), (X, ys), Trie(), num_samples=300,
              num_warmup=200, num_chains=16, num_leapfrog=8, device="cpu")
    assert out["fused_quadratic"] is False
    w_map = map_newton(X.numpy(), ys.numpy())
    ws = out["samples"]["w"].double().numpy()[:, 100:].reshape(-1, d)
    # the posterior mean within a posterior-sd-scale ball of the MAP
    np.testing.assert_allclose(ws.mean(0), w_map, atol=0.1)
    # and the MAP recovers the truth's direction
    np.testing.assert_allclose(w_map, np.array([1.0, -1.0]), atol=0.5)


def test_hmc_marginalized_hierarchical():
    """test_factor_marginalized.py:63-89's bounds. The reference runs 4
    chains for 800 + 1500 iterations at L = 24; here 256 pooled chains for
    300 + 300 at L = 12."""
    xs = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
    a, b, c = 0.2, 0.5, 0.3
    ys = a + b * xs + c * xs * xs
    p_lin, m_lin, _, m_quad, _, _ = exact_hierarchical_posterior(xs, ys)
    out = hmc(4, make_hierarchical_marginalized(len(xs)),
              (tensor(xs), tensor(ys)), Trie(), num_samples=300,
              num_warmup=300, num_chains=256, num_leapfrog=12, device="cpu")
    assert out["fused_quadratic"] is False
    s = {k: out["samples"][f"coeffs / {k}"].numpy().ravel() for k in "abc"}
    # the exact mixture's moments: the linear branch leaves c at its prior
    assert s["a"].mean() == pytest.approx(
        p_lin * m_lin[0] + (1 - p_lin) * m_quad[0], abs=0.05)
    assert s["b"].mean() == pytest.approx(
        p_lin * m_lin[1] + (1 - p_lin) * m_quad[1], abs=0.05)
    assert s["c"].mean() == pytest.approx((1 - p_lin) * m_quad[2], abs=0.08)
    assert torch.isfinite(out["unconstrained"]).all()
