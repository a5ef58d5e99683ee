"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` resolves to its entry in ``workloads``, the
configuration file its ``configs`` entry names, the traffic mix
``traffic/<traffic>.json`` (parameters only), the kind of traffic its
``kind`` names, ``kinds/<kind>.py`` (the unit of work, the window and its
end-to-end values, what is judged), the plain reference
``reference/<config>.py`` and, for each metric, ``metrics/<metric>.py``.
Later cells, mixes, kinds, configurations and metrics add files; none of
this code changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


class Cell(NamedTuple):
    name: str
    entry: dict           # the workloads entry
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports


def load(path: Path = BENCHMARK) -> dict:
    with open(path) as handle:
        return json.load(handle)


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def resolve(bench: dict, workload: str) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    entry = entries[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[entry["config"]]["file"]) as handle:
        config = json.load(handle)
    with open(HERE / "traffic" / f"{entry['traffic']}.json") as handle:
        traffic = json.load(handle)
    return Cell(name=workload, entry=entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)])


def load_file(path: Path):
    """A module from a file whose name need not be an identifier."""
    module_spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace("-", "_")
        .replace(".", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def reference(config_name: str):
    return load_file(HERE / "reference" / f"{config_name}.py")


def metric_reader(metric_name: str):
    return load_file(HERE / "metrics" / f"{metric_name}.py")


def kind(traffic: dict):
    return load_file(HERE / "kinds" / f"{traffic['kind']}.py")
