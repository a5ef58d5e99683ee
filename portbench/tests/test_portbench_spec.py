"""BENCHMARK.json against the contract, and every file it names found by
name."""
import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = spec.load()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    seconds = BENCH["run_seconds"]
    assert 1 <= seconds <= 51
    runs = 2 + 14 * 24
    assert runs * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] == 0.25
    for metric in BENCH["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_by_name(workload):
    cell = spec.resolve(BENCH, workload)
    assert cell.entry["chips"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                   "experiment_s"}
    assert cell.per_layer
    assert cell.traffic["kind"] == "experiment"
    assert cell.config["name"] == cell.entry["config"]
    assert cell.config["limits"]
    ref = spec.reference(cell.entry["config"])
    for fn in ("prepare", "factor_checks", "user_panel", "item_panel",
               "model_flops"):
        assert callable(getattr(ref, fn))
    kind = spec.kind(cell.traffic)
    for fn in ("warm", "window", "judge"):
        assert callable(getattr(kind, fn))
    for metric in cell.per_layer:
        assert callable(spec.metric_reader(metric["name"]).read)


def test_every_config_is_used_and_uncut():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(set(files)) == len(files)
    for config in BENCH["configs"]:
        assert config["file"].startswith("portbench/")
        assert config["reduced"] == []


def test_per_layer_moves_a_reported_end_to_end_metric():
    end_to_end = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in end_to_end
        assert set(metric["workloads"]) <= set(WORKLOADS)
        layers.setdefault(metric["layer"], []).append(metric["name"])
    assert set(layers) == {"data tier", "factorization",
                           "scoring and evaluation", "kernel", "device"}


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.resolve(BENCH, "nope.experiment")
