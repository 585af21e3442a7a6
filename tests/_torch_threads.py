"""A fixture the port's test modules import: they run torch on one thread.

The suite runs in several worker processes at once; torch's thread pool in
each would oversubscribe the cores, and the port's test tensors are small.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
