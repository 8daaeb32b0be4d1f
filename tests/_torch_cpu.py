"""Shared settings of the port's CPU test files.

Each port test file imports ``one_torch_thread`` (an autouse fixture, so the
import is all it takes)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's CPU ops on one intra-op thread for the module, the count
    restored after it. The port's CPU tests run many small tensor ops beside
    the suite's other parallel workers: intra-op threads that wait on one
    another for every op cost more than the ops and take the cores the other
    workers need (a case of the split-precision tests ran 0.05 s alone and
    5-9 s beside five busy workers; the port's test files took half the
    worker time on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
