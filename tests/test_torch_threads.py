"""One intra-op thread for the port's test modules.

The repository's test run spreads test files over several pytest-xdist
workers that share the machine's cores. A worker's team of torch intra-op
threads meets at a barrier in every tensor op, and waits there for the
threads that the other workers keep off the cores. The port's plain versions
run thousands of small tensor ops, so such cases ran 100 to 300 times as long
as they run alone (``test_trace_tile_exact_equals_per_ray_trace[terrain-7-
128]``: 278 s in a run of six workers, 1.9 s alone). Each ``test_torch_*.py``
module imports ``one_torch_thread``, an autouse fixture that runs the
module's tests with one intra-op thread and restores the count after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
