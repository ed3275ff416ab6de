"""A fixture for the port's heavier CPU test files: import it into a test
module (``from .torch_threads import one_torch_thread``) and every test of
that module runs with one torch thread.

The suite runs several pytest workers on one machine; each worker's default
torch pool (a thread per core) oversubscribes the cores, and the pools'
spinning threads then slow every worker several times over.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
