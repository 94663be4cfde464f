"""One torch thread for each PyTorch-port test module.

The tests run under several pytest-xdist workers on one host. Each worker
would otherwise run torch's intra-op pool (OpenMP, as many threads as
cores) beside the other workers' pools and XLA's: the threads then spin in
each other's way, and a port module that takes a minute alone took over
ten under the full run. The port's CPU tests run tiny shapes, so one
thread costs them little alone and keeps them fast under load. A test
module imports the fixture to take it:

    from torch_test_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
