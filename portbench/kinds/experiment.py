"""The ``experiment`` kind of traffic: a researcher's unit of work, a
fresh model's ``build()`` then ``evaluate()`` over every test user,
repeated.

Parameters (``traffic/<mix>.json``): ``topk``, ``filter_seen`` and
``metric_type`` (the argument of ``evaluate``).  The window repeats the
step until ``seconds`` have passed and finishes the step then running;
``experiment_s`` is its whole steps' time over their count.  Set-up
warms the step's shapes with the configuration's ``model.warm``
settings (the same shapes, less work).
"""
from __future__ import annotations

import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from portbench import judge as judging
from portbench.harness import Window
from portbench.system import sync


class StepOutput(NamedTuple):
    factors: dict          # the model's factor tensors by name
    recs: np.ndarray       # (n_test, k) picks, internal item ids
    metrics: dict          # flat {metric: value} from evaluate()
    seconds: float         # host clock of the whole step, synchronized
    spans: dict            # host clock of its parts: {"evaluate": s}
    counters: dict         # {metric: value} of the metrics' collectors


def _flat(scores) -> dict:
    metrics = {}
    for family in (scores if isinstance(scores, list) else [scores]):
        metrics.update({name: float(value) for name, value
                        in family._asdict().items() if value is not None})
    return metrics


def warm(system) -> None:
    """One step's shapes with less work: loads the kernel library and the
    libraries' kernels that the window's steps use."""
    model = system.new_model(system.cfg["model"].get("warm"))
    model.build()
    model.evaluate(system.traffic["metric_type"])
    sync(system.device)


def step(system, spans, collectors) -> StepOutput:
    """One unit of work, timed; its outputs and counters are read after
    its clock stopped."""
    start = time.perf_counter()
    model = system.new_model()
    with spans("build"):
        model.build()
        sync(system.device)
    with spans("evaluate"):
        evaluate_start = time.perf_counter()
        scores = model.evaluate(system.traffic["metric_type"])
        sync(system.device)
        end = time.perf_counter()
    with spans("collect"):
        factors = {name: value for name, value in model.factors.items()
                   if isinstance(value, torch.Tensor)}
        return StepOutput(
            factors=factors, recs=np.asarray(model.recommendations),
            metrics=_flat(scores), seconds=end - start,
            spans={"evaluate": end - evaluate_start},
            counters={name: collect(model)
                      for name, collect in collectors.items()})


def window(system, seconds, spans, collectors) -> Window:
    """Whole steps until ``seconds`` have passed (at least one)."""
    outputs, error = [], None
    start = time.perf_counter()
    while True:
        try:
            outputs.append(step(system, spans, collectors))
        except Exception:                # judged by the harness: not correct
            error = traceback.format_exc()
            break
        if time.perf_counter() - start >= seconds:
            break
    values = {}
    if outputs:
        values["experiment_s"] = sum(o.seconds for o in outputs) \
            / len(outputs)
    return Window(outputs=outputs, values=values, error=error)


def judge(ref, state, problem, outputs, limits, traffic, device):
    """Every step's factors, picks and metric values (``judge.py``)."""
    return judging.judge_steps(ref, state, problem, outputs, limits,
                               traffic["topk"], device)
