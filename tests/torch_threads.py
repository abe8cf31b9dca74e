"""The port's tests' ``one_thread`` fixture. A test file takes it by
importing it (``from torch_threads import one_thread``) and naming it, or
through ``pytestmark = pytest.mark.usefixtures("one_thread")``."""
import pytest
import torch


@pytest.fixture
def one_thread():
    """torch on one intra-op thread for the test. The tests that take it
    run many small steps: beside the parallel suite's other workers,
    torch's one thread a core in every worker oversubscribes the CPU (the
    real-read overfit took 749 s on 8 threads there, 8.1 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
