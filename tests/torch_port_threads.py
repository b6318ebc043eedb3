"""A module-scoped autouse fixture shared by the ``test_torch_port_*`` files.

The test lane runs several pytest workers on one machine, each with JAX's
thread pool beside torch's. Torch's intra-op threads then oversubscribe the
cores and spin-wait: a tiny-config pipeline run that takes one second alone
took ninety under the lane's workers. One torch thread per worker avoids it.
Import the fixture into a test module to activate it there.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
