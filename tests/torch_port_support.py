"""Shared fixture of the ``tests/test_torch_*.py`` files.

Import ``single_torch_thread`` into a test module to make it autouse there.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Run the module's torch ops on one thread. The tier-1 run puts several
    pytest workers on one shared CPU; at these tiny shapes torch's per-worker
    thread pool only oversubscribes it and slows every worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
