"""Shared fixture of the port's CPU tests (import it into a test module)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process: the plain kernel versions run
    many small tensor ops, and parallel test workers that each spin up a
    full thread pool oversubscribe the cores and stall one another."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
