"""An autouse fixture for the port's CPU-heavy test files: one intra-op
thread a test.  Their shapes are small, and the suite's xdist workers
share the machine's cores: at eight threads a worker they spin against
each other (jamba's entry-point run took 211 s under the whole suite, 8 s
alone), and one thread costs each test about half the CPU time.  Import
it into a test module to apply it there:

    from _one_thread import one_thread  # noqa: F401  (autouse)
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
