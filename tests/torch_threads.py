"""The port's test modules on one intra-op thread of torch (not a test
module).

The tests run under pytest-xdist, several workers on the same cores. Each
small torch op (an sLSTM step, a client of the per-client loop, a round's
stage at the tests' sizes) forks over every core by default, so the
workers' threads wait on one another and such a test runs several times
slower than alone. A module that imports :func:`one_torch_thread` runs on
one thread and restores the count when it is done.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
