"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests marked ``card`` need a CUDA device; each decides inside itself
whether there is one and skips with a reason where there is none. On the
card: ``python3 -m pytest portbench/tests -m card``.
"""

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")
