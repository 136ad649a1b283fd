"""NUTS on Neal's funnel with adaptation (``tests/test_nuts.py::
test_nuts_funnel_divergences`` part (b)) at its bounds, on the CPU.

At target accept 0.99 the trees run 5-6 doublings deep, ~60 value-and-grad
calls a transition at ~8 ms each on the CPU, so the gate runs 32 chains for
50 + 50 iterations (the reference: 8 chains, 800 + 1500; ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.nuts import nuts

from test_torch_nuts import funnel
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _float64():
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(saved)


def test_nuts_funnel_adapted():
    out = nuts(3, funnel, (), Trie(), num_samples=50, num_warmup=50,
               num_chains=32, max_depth=8, target_accept=0.99, device="cpu")
    vs = out["samples"]["v"].numpy().ravel()
    assert float(out["divergences"].double().mean()) < 0.1
    assert vs.mean() == pytest.approx(0.0, abs=0.6)
    assert vs.std() == pytest.approx(3.0, rel=0.25)
