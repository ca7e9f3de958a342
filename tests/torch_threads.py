"""The port's test files share one thread policy: a test module imports
``one_thread`` (``from torch_threads import one_thread  # noqa: F401``) and
its tests run with one intra-op thread, since the tier-1 run's pytest
workers share the CPU."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
