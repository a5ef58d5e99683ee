"""Smoke-run every ``examples_torch/*.py`` script on the CPU
(``main("cpu")``), as ``tests/test_examples.py`` runs the JAX package's
examples: each must run and print.  ``lightfm_vs_hybridsvd.py`` runs
against the fake ``lightfm`` module installed here, and without it says
that the comparison was skipped."""
import importlib.util
import io
import pathlib
import sys
from contextlib import redirect_stdout

import pytest
import torch

import _fake_lightfm

EXAMPLES_DIR = (pathlib.Path(__file__).resolve().parent.parent
                / "examples_torch")
EXAMPLES = sorted(p.stem for p in EXAMPLES_DIR.glob("*.py"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each example on one torch thread: the examples run many small torch
    ops, and beside the JAX examples in the suite's parallel workers a
    torch pool on every core and XLA's contend until both run tens of
    times slower than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_torch_{name}", EXAMPLES_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(spec.name, None)
    return module


def _run(name):
    buf = io.StringIO()
    with redirect_stdout(buf):
        _load(name).main("cpu")
    return buf.getvalue()


def test_every_example_has_a_counterpart():
    jax_examples = pathlib.Path(__file__).resolve().parent.parent / \
        "examples"
    assert EXAMPLES == sorted(p.stem for p in jax_examples.glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name):
    _fake_lightfm.install()
    output = _run(name)
    assert output.strip(), f"{name} produced no output"
    if name == "lightfm_vs_hybridsvd":
        assert "LightFM (rank 20)" in output


def test_lightfm_example_without_lightfm_says_it_skipped(monkeypatch):
    monkeypatch.setitem(sys.modules, "lightfm", None)
    output = _run("lightfm_vs_hybridsvd")
    assert "LightFM comparison skipped" in output
    assert "ScaledHybridSVD" in output
