"""A module-scoped autouse fixture that runs a test file's torch CPU work
on one intra-op thread.

The tier-1 suite runs six pytest workers on one host; with torch's default
(one thread per core) each worker's many small CPU ops spin OpenMP threads
against the other workers' and a parity file took 580 s instead of 115 s
under that load. One thread changes no check: the files hold both
packages to tolerances far above reduction-order rounding. Import the
fixture into a test module to use it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
