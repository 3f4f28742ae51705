"""One thread per test worker for the port's CPU tests.

The tier-1 run spreads the test files over several worker processes on one
machine's cores, and torch and the BLAS each start a thread a core in
every worker: six workers on eight cores ran 96 threads, and the port's
files took 1.7 times their worker time on one thread.  Every port test
file imports ``one_thread_per_worker``, which holds torch and the BLAS to
one thread while that file's tests run and gives the threads back after.

The port's files of at most three tests also import
``below_the_longest_file``: xdist hands those files out after the suite's
longest one (tests/test_graft_entry.py, whose XLA threads fill the
cores), so they run beside it; at nice 10, with the processes they start,
they take the cores it leaves idle instead of slowing it.
"""
import os

import pytest
import torch
from threadpoolctl import threadpool_info, threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def one_thread_per_worker():
    """torch and the BLAS on one thread for the importing module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def below_the_longest_file():
    """nice 10 for the importing module's tests (and the processes they
    start), back to the worker's priority after, where the process may
    raise it again."""
    os.nice(10)
    yield
    try:
        os.nice(-10)
    except PermissionError:
        pass


def test_one_thread_per_worker_holds_torch_and_the_blas_to_one_thread():
    assert torch.get_num_threads() == 1
    assert all(pool["num_threads"] == 1 for pool in threadpool_info())
