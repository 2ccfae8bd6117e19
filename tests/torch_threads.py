"""One PyTorch intra-op thread for the port's CPU tests.

The tests run in several worker processes at once, and each PyTorch
process otherwise starts a thread per core: the workers' threads then
contend for the cores, and a test of many small operations runs tens of
times slower than alone. Each ``tests/test_torch_*.py`` module imports
``one_torch_thread``; pytest applies it to that module's tests and puts
the thread count back after them. Results do not depend on it beyond
float round-off.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
