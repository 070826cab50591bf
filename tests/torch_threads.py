"""One torch thread for the CPU tests that train: the tier-1 run puts
six pytest-xdist workers on the host's cores, and a worker's full team of
torch threads then spends most of its time waiting beside the others'
(such a file took about ten times its time alone).  A test module uses
it by importing the fixture."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
