"""The port's import boundary: ``polara_tpu_torch`` loads no jax and
nothing of ``polara_tpu``; its device tier and the plotting module load
neither pandas nor matplotlib."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORTS = ("import polara_tpu_torch, polara_tpu_torch.models.svd, "
           "polara_tpu_torch.ops.scoring, "
           "polara_tpu_torch.evaluation.metrics, "
           "polara_tpu_torch.models.baselines, polara_tpu_torch.native, "
           "polara_tpu_torch.ops.similarity, polara_tpu_torch.runtime, "
           "polara_tpu_torch.runtime.mesh, polara_tpu_torch.parallel, "
           "polara_tpu_torch.evaluation.plotting, "
           "polara_tpu_torch.ops.cholesky, polara_tpu_torch.models.hybrid, "
           "polara_tpu_torch.models.coldstart, polara_tpu_torch.ops.sparse, "
           "polara_tpu_torch.parallel.distributed, "
           "polara_tpu_torch.models.implicit_mf, "
           "polara_tpu_torch.runtime.memory, "
           "polara_tpu_torch.datasets.synthetic, "
           "polara_tpu_torch.ops.samplers, polara_tpu_torch.models.sampled, "
           "polara_tpu_torch.models.contextual")
# the pandas tier: the data model, the experiment pipelines, the
# preprocessing functions and feature encoders, the import-path aliases
# and the external adapters
PANDAS_TIER = ("import polara_tpu_torch.data, "
               "polara_tpu_torch.evaluation.engine, "
               "polara_tpu_torch.evaluation.pipelines, "
               "polara_tpu_torch.preprocessing, "
               "polara_tpu_torch.recommender, "
               "polara_tpu_torch.models.external")


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_import_loads_no_jax_module():
    proc = _run(f"""
        import sys
        before = set(sys.modules)
        {IMPORTS}
        {PANDAS_TIER}
        new = sorted(set(sys.modules) - before)
        bad = [m for m in new if m.split(".")[0] in ("jax", "jaxlib")
               or m == "polara_tpu" or m.startswith("polara_tpu.")]
        print("BAD", bad)
        """)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_import_with_pandas_blocked():
    proc = _run(f"""
        import sys
        sys.modules["pandas"] = None   # any 'import pandas' now raises
        sys.modules["matplotlib"] = None
        {IMPORTS}
        import polara_tpu_torch.datasets, polara_tpu_torch.runtime.convert
        print("IMPORTED")
        """)
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED" in proc.stdout
