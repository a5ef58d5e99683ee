"""Limits for every pytest process in this repository: one thread budget for
the process, and a time limit for each test under ``tests/``."""
import faulthandler
import os
import pathlib
import signal

import pytest

# N xdist workers that each start BLAS, OpenMP and torch pools on every core
# oversubscribe the same cores, and ARPACK's and torch's many small calls then
# run tens of times slower than alone.  So each process gets the cores over
# the workers: the env vars reach libraries loaded later and subprocesses,
# threadpoolctl the pools already loaded (hence the imports before it).
THREAD_BUDGET = max(1, len(os.sched_getaffinity(0))
                    // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
for var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = str(THREAD_BUDGET)
import numpy  # noqa: E402,F401
import scipy.linalg  # noqa: E402,F401
import scipy.sparse.linalg  # noqa: E402,F401

try:
    import torch
except ImportError:
    pass
else:
    torch.set_num_threads(THREAD_BUDGET)
try:
    import threadpoolctl
except ImportError:  # not installed beside the CUDA build
    pass
else:
    threadpoolctl.threadpool_limits(THREAD_BUDGET)

TESTS = pathlib.Path(__file__).resolve().parent / "tests"


@pytest.fixture
def thread_budget():
    return THREAD_BUDGET


def pytest_addoption(parser):
    parser.addini("test_time_limit", "seconds a test under tests/ may take, "
                  "set-up and teardown included", default="240")


def pytest_configure(config):
    # stderr as it is between tests (capture redirects fd 2 during one),
    # for a stuck test's traceback.
    global STDERR_FD
    STDERR_FD = os.dup(2)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    """Fail a test under ``tests/`` that runs past ``test_time_limit``, by
    name.  SIGALRM's handler runs only when control is back in Python, so a
    test stuck inside a C call is ended 30 s later by faulthandler, which
    dumps its traceback and exits the process."""
    if not item.path.is_relative_to(TESTS):
        return (yield)
    seconds = int(item.config.getini("test_time_limit"))

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its {seconds} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    faulthandler.dump_traceback_later(seconds + 30, exit=True, file=STDERR_FD)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
