"""One intra-op thread for the port's CPU tests.

The port's plain versions run many small tensor ops: one thread runs them
faster than a pool does, and under pytest-xdist's parallel workers a pool
per worker oversubscribes the cores (each op then waits for its threads).
Test modules import the fixture below, which applies to every test in the
module and restores the setting after it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
