"""The port's CPU tests on one intra-op thread.

Every ``tests/test_torch_*.py`` module applies the fixture by importing it
(an autouse fixture in a module's namespace applies to that module)::

    from torch_threads import one_torch_thread  # noqa: F401

The tier-1 run puts six xdist workers on the machine, and torch's default
pool gives each as many threads as there are cores. The port's tiny steps
are thousands of small ops, and beside other busy processes each threaded
op waits on its slowest thread: ~90x slower in a loaded parallel run, 4x
beside 8 busy cores. ``OMP_NUM_THREADS`` carries the count into the
subprocesses and spawned ranks a test starts. ``tests/test_torch_package.py``
checks that every port test module imports the fixture and that nothing
else in ``tests/`` sets the count but the two places that mirror the
program's own rank threads (the fleet replay, the parallel rank worker).
"""

import os

import pytest
import torch

THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on ``THREADS`` intra-op threads for the module, in this process
    and (by ``OMP_NUM_THREADS``) in the processes it starts; both restored
    afterwards."""
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp
