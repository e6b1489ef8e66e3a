"""A fixture for the port's CPU tests that run small PyTorch steps."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch's CPU ops on one thread while the module runs.  The tier runs
    six test processes on eight cores; there a small op's eight-thread pool
    waits on its threads far longer than it computes (a step of the small
    model took minutes instead of a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
