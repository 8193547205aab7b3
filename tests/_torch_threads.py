"""A fixture the port's heavier CPU test modules share: parallel test
workers share the machine's cores, and torch's own thread pool in each
would oversubscribe them (about 5x slower with six workers)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
