"""A module-scoped fixture that runs a test module's PyTorch work on one
intra-op thread: the suite runs several test processes at once on a few
cores, and PyTorch's default of one thread per core in each process makes
them contend for the cores (a ``train()`` run took 185 s with six such
processes at the default, 6.5 s with one thread each). Import it into a
test module to use it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
