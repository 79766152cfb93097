"""One torch thread a test process: the tests run in several processes at
once, and the CPU runs of the harness keep to their calls' pace."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
