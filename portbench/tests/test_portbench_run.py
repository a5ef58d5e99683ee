"""Whole runs at a small size on the CPU: the result line's shape, the
trace reduction, and the faults the check has to catch."""
import json
import math

import numpy as np
import pytest
import torch

from portbench import harness, spec, trace

SMALL = dict(n_users=300, n_items=200, n_events=8000)
SEED = 2 ** 31 + 977          # past 32 signed bits, as run seeds may be
WORKLOADS = [w["name"] for w in spec.load()["workloads"]]


def run(workload, traced=False, seed=SEED, **kwargs):
    return harness.run_cell(workload, seed, 0.0, traced, device="cpu",
                            geometry=SMALL, **kwargs)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_shape(workload, traced, capsys):
    result = run(workload, traced)
    line = json.loads(json.dumps(result.line))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    cell = spec.resolve(spec.load(), workload)
    reported = cell.per_layer if traced else cell.end_to_end
    names = {m["name"] for m in reported}
    assert set(line["metrics"]) <= names
    if not traced:
        assert set(line["metrics"]) == {"setup_s", "experiment_s"}
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
        assert math.isfinite(metric["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    assert ("breakdown" in line) == traced
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
    for name, check in line["checks"].items():
        assert set(check) == {"value", "limit"}
        assert check["value"] <= check["limit"], name


def test_traced_run_reads_the_host_clock_from_the_unprofiled_window(
        monkeypatch):
    records = []
    original = harness._per_layer

    def keep(cell, record):
        records.append(record)
        return original(cell, record)

    monkeypatch.setattr(harness, "_per_layer", keep)
    result = run(WORKLOADS[0], traced=True)
    record, = records
    assert record.window.outputs and record.traced.outputs
    assert result.line["attempted"] == len(record.window.outputs) + \
        len(record.traced.outputs)
    builds = [o.counters["build_s"] for o in record.window.outputs]
    assert result.line["metrics"]["build_s"]["value"] == pytest.approx(
        sum(builds) / len(builds))
    assert record.trace.window_s <= sum(o.seconds for o in
                                        record.traced.outputs) + 1.0


def test_device_count_is_the_cells_chips():
    result = run(WORKLOADS[0])
    chips = spec.resolve(spec.load(), WORKLOADS[0]).entry["chips"]
    assert result.line["device"]["count"] == chips


def test_same_seed_same_inputs():
    from portbench import synthetic
    a = synthetic.make_events(**SMALL, seed=SEED, device="cpu")
    b = synthetic.make_events(**SMALL, seed=SEED, device="cpu")
    c = synthetic.make_events(**SMALL, seed=SEED + 1, device="cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a.cols, c.cols)
    hold = synthetic.holdout_mask(a.rows, SEED)
    assert hold.sum() == len(np.unique(a.rows))


def test_trace_reduction():
    us = 1e6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 0, "dur": 10 * us},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.build",
         "ts": 0, "dur": 6 * us},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.evaluate",
         "ts": 6 * us, "dur": 4 * us},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 2 * us,
         "dur": 2 * us},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 0, "dur": 2 * us},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1 * us,
         "dur": 1.5 * us},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 4 * us,
         "dur": 2 * us},
        {"ph": "X", "cat": "kernel", "name": "score_topk_kernel<1>",
         "ts": 7 * us, "dur": 1 * us},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 11 * us,
         "dur": 1 * us},
    ]
    summary = trace.reduce_events(events)
    assert summary.window_s == pytest.approx(10)
    assert summary.busy_s == pytest.approx(2.5 + 2 + 1)
    assert dict(summary.device_ops) == pytest.approx(
        {"gemm": 3.5, "copy": 2, "score_topk_kernel<1>": 1})
    assert dict(summary.idle_gaps) == pytest.approx(
        {"build: aten::item": 1.5, "evaluate: python": 1 + 2})
    import re
    assert summary.seconds_matching(re.compile("score_topk")) == 1


def test_no_forbidden_module_in_a_run():
    run(WORKLOADS[0])
    assert harness.forbidden_modules() == []


def test_command_prints_no_result_without_a_card_or_the_port(tmp_path):
    import shutil
    import subprocess
    import sys
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", WORKLOADS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


# ---- faults: each must make ``correct`` come out false -------------------

def test_fault_build_leaves_its_state_unchanged(monkeypatch):
    from portbench.system import PortSystem
    built = {}
    original = PortSystem.new_model

    def new_model(self, *args, **kwargs):
        model = original(self, *args, **kwargs)
        cls = type(model)
        if cls in built:                 # after set-up's warm step
            monkeypatch.setattr(model, "build", lambda *a, **k: None)
        built[cls] = True
        return model

    monkeypatch.setattr(PortSystem, "new_model", new_model)
    for workload in WORKLOADS:
        built.clear()
        result = run(workload)
        assert result.line["correct"] is False
        assert result.line["failed"] >= 1


def test_fault_half_the_batch_left_out(monkeypatch):
    import polara_tpu_torch.models.base as base
    original = base.compute_metrics

    def half(recommendations, holdout, key, **kwargs):
        n = recommendations.shape[0] // 2
        users = holdout[key].drop_duplicates().iloc[:n]
        return original(recommendations[:n],
                        holdout[holdout[key].isin(users)], key, **kwargs)

    monkeypatch.setattr(base, "compute_metrics", half)
    for workload in WORKLOADS:
        result = run(workload)
        assert result.line["correct"] is False
        assert result.checks["metric_gap"][0] > \
            result.checks["metric_gap"][1]


def test_fault_an_answer_altered_where_it_is_produced(monkeypatch):
    import polara_tpu_torch.models.base as base

    def altered(route):
        def scoring(*args, **kwargs):
            recs = route(*args, **kwargs)
            recs = recs.clone() if isinstance(recs, torch.Tensor) \
                else recs.copy()
            recs[0, 0] = recs[0, -1]       # one pick repeated
            return recs
        return scoring

    monkeypatch.setattr(base, "run_scoring", altered(base.run_scoring))
    monkeypatch.setattr(base, "run_scoring_fused",
                        altered(base.run_scoring_fused))
    for workload in WORKLOADS:
        result = run(workload)
        assert result.line["correct"] is False
        assert result.checks["bad_picks"][0] >= 1
