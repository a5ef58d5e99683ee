"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the plain references import nothing of the port, and nothing reads the
JAX package's benchmark files."""
import ast

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "polara_tpu"}
PORT = "polara_tpu_torch"
# the yardstick: everything but the modules that run the system under test
RUNNERS = {"system.py", "harness.py", "run.py", "control.py"}
MODULES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(node.args[0].value)
    return {name.split(".")[0] for name in names}


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not imported_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in MODULES
                                  if p.name not in RUNNERS
                                  and "tests" not in p.parts],
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert PORT not in imported_names(path)


def test_the_top_level_name_is_compared_whole(tmp_path):
    port = tmp_path / "port.py"
    port.write_text("import polara_tpu_torch.models\n")
    jax_package = tmp_path / "jax_package.py"
    jax_package.write_text("from polara_tpu.ops import pallas\n")
    assert not imported_names(port) & FORBIDDEN
    assert imported_names(jax_package) & FORBIDDEN == {"polara_tpu"}


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_reads_no_jax_benchmark_file(path):
    text = path.read_text()
    for name in ("bench.py", "BENCH_", "benchmarks/"):
        assert name not in text or path.name.startswith("test_portbench_i")
