"""The one-thread fixture of the port's CPU tests.  A test module imports
it (``from _torch_threads import _one_thread``) and it runs around every
test of that module."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: torch's intra-op threads only spin here, and under the
    suite's parallel workers they take the cores from every other test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
