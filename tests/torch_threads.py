"""One intra-op thread for the port's CPU tests.

The port's CPU tests run tiny models through long loops of small PyTorch
ops. Each op that PyTorch runs in parallel makes all of its intra-op
threads meet, and the suite runs in several worker processes at once, each
sized for the whole machine: a thread of one process waits on threads of
the others, and a loop of microsecond ops slows tenfold or more. Importing
``one_torch_thread`` into a test module runs that module's tests on one
intra-op thread and restores the count after them. The JAX engines that
the tests compare against keep their own thread pools.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
