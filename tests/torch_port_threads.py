"""One torch intra-op thread for the port's CPU tests.

Each ``tests/test_torch_*.py`` imports ``one_torch_thread``, an autouse
fixture of module scope: torch runs its CPU kernels on one thread while the
module's tests run, and gets its previous count back after them. The suite
runs in several pytest workers at once, beside XLA's compiles; torch's
default of one thread per core in every worker oversubscribed the cores, and
a forward that takes seconds alone took minutes there.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
