"""Each test process keeps to the root ``conftest.py``'s thread budget (the
cores over the xdist workers), and a test under ``tests/`` that runs past its
time limit fails by name."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import threadpoolctl

ROOT = pathlib.Path(__file__).resolve().parent.parent

STUCK = """
import time

import pytest


@pytest.fixture
def slow_set_up():
    time.sleep(60)


def test_set_up(slow_set_up):
    pass


def test_call():
    time.sleep(60)


def test_after():
    time.sleep(0.5)
"""


def test_budget_is_cores_over_workers(thread_budget):
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert thread_budget >= 1
    assert thread_budget == 1 or thread_budget * workers <= cores
    assert (thread_budget + 1) * workers > cores


def test_loaded_pools_keep_to_the_budget(thread_budget):
    info = threadpoolctl.threadpool_info()
    assert "blas" in {e["user_api"] for e in info}
    assert [e for e in info if e["num_threads"] > thread_budget] == []


def test_torch_keeps_to_the_budget(thread_budget):
    torch = pytest.importorskip("torch")
    assert torch.get_num_threads() <= thread_budget


@pytest.mark.parametrize("var", ["OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                                 "MKL_NUM_THREADS"])
def test_subprocesses_inherit_the_budget(var, thread_budget):
    assert os.environ[var] == str(thread_budget)


def test_time_limit_fails_the_test_by_name(tmp_path):
    """A 1 s limit fails a test stuck in set-up and one stuck in its call,
    each by its own name, and the next test runs clear of both alarms."""
    shutil.copy(ROOT / "conftest.py", tmp_path)
    (tmp_path / "pytest.ini").write_text("[pytest]\ntest_time_limit = 1\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_stuck.py").write_text(STUCK)
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-q", "-rA",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "COLUMNS": "300"})
    lines = run.stdout.splitlines()
    for outcome, test in [("ERROR", "test_set_up"), ("FAILED", "test_call")]:
        name = f"tests/test_stuck.py::{test}"
        assert (f"{outcome} {name} - Failed: {name} ran past its 1 s limit"
                in lines), run.stdout
    assert "PASSED tests/test_stuck.py::test_after" in lines, run.stdout
    assert run.returncode == 1, run.stdout
