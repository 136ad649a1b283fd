"""One intra-op thread for the port's CPU tests.

The suite runs several pytest workers on one host, and torch's OpenMP pool
keeps a thread a core busy in each of them, so the workers take each
other's cores: ``tests/test_torch_logreg.py`` alone ran in 76 s of wall
and 287 s of CPU on eight threads, in 46 s and 45 s on one. Each port test
module imports ``one_thread``, an autouse module fixture that runs its
tests on one thread and restores the count after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
