"""An autouse fixture for the port's heavier CPU tests: torch runs a test
module (its module fixtures included) on one intra-op thread, and the
previous count comes back after it.

The suite runs on several xdist workers at once; torch's default of one
thread per core in every worker oversubscribes the cores, and the many
small ops of the sharded engines (eight shards, the HNSW beam) then run
some hundred times slower than alone. Import the fixture into a test
module to apply it there:

    from tests.torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
