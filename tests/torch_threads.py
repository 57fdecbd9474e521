"""One intra-op thread for the port's CPU tests.

The suite runs several pytest workers at once on a machine with a few
cores; torch's default of a thread a core in each of them oversubscribes
the cores, and the port's eager ops (many small tensors) then spend their
time waking threads. A test module takes this fixture with
``from torch_threads import one_torch_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
