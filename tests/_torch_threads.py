"""The autouse fixture the port's slower test files share: import
``_one_thread`` into a test module to run its tests on one intra-op
thread."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for the plain versions' many small ops, so
    that parallel test workers do not oversubscribe the cores (tens of
    times slower when they do)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
