"""The comparison that decides ``correct``.

Every step of the window is judged: the factors its build returned
against the configuration's plain reference, its picks against f64 scores
of those factors, and its metric values against the same metrics
recomputed in numpy from its picks.  A number passes when it is at or
below its limit (an exact comparison has the limit 0).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import plain


def step_checks(ref, state: dict, problem: plain.Problem, factors: dict,
                recs: np.ndarray, metric_values: Dict[str, float], k: int,
                device) -> Dict[str, float]:
    """The numbers compared for one step's outputs."""
    values = dict(ref.factor_checks(state, factors))

    def scores_of(rows):
        return (ref.user_panel(factors, problem, rows, device)
                @ ref.item_panel(factors, device).T)

    values.update(plain.judge_picks(problem, recs, scores_of, k, device))
    values["metric_gap"] = plain.metric_gap(metric_values,
                                            plain.metrics(problem, recs))
    return values


def passes(value: float, limit: float) -> bool:
    return not math.isnan(value) and value <= limit


def _same(a, b) -> bool:
    if a.recs.shape != b.recs.shape or not np.array_equal(a.recs, b.recs):
        return False
    if a.metrics != b.metrics or set(a.factors) != set(b.factors):
        return False
    return all(torch.equal(a.factors[n], b.factors[n]) for n in a.factors)


def judge_steps(ref, state: dict, problem: plain.Problem, steps: list,
                limits: Dict[str, float], k: int, device
                ) -> Tuple[Dict[str, float], int]:
    """The widest reading of each number over the steps, and how many
    steps failed a limit.  A step whose outputs equal an earlier step's,
    bit for bit, takes that step's readings."""
    judged: List[Tuple[object, Dict[str, float]]] = []
    worst: Dict[str, float] = {}
    failed = 0
    for step in steps:
        values = next((v for s, v in judged if _same(s, step)), None)
        if values is None:
            values = step_checks(ref, state, problem, step.factors,
                                 step.recs, step.metrics, k, device)
            judged.append((step, values))
        if set(values) != set(limits) or not all(
                passes(values[n], limits[n]) for n in limits):
            failed += 1
        for name, value in values.items():
            old = worst.get(name, -math.inf)
            worst[name] = value if math.isnan(value) else max(old, value)
    return worst, failed
