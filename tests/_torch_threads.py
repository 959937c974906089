"""One intra-op thread for a test module of the port's many small CPU ops.

The suite runs in several worker processes at once; torch's default of
one intra-op thread per core then oversubscribes the host, and each small
op (a decode step has hundreds) waits on threads that spin for a core.
A module imports :func:`one_torch_thread` (an autouse fixture) to run
its tests on one thread and restore the setting after:

    from _torch_threads import one_torch_thread  # noqa: F401
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)
