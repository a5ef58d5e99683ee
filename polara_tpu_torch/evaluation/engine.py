"""Experiment orchestration: cross-validation, top-k and holdout sweeps.

Host copy of :mod:`polara_tpu.evaluation.engine` (reference
``polara/evaluation/evaluation_engine.py``): loops mutate the shared data
model (which invalidates subscribed models through the event system) and
consolidate metric namedtuples into pandas frames.  The models compute on
their own devices.
"""
from __future__ import annotations

from math import sqrt
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import pandas as pd


def sample_ci(df: pd.DataFrame, coef: float = 2.776,
              level=None) -> pd.DataFrame:
    """95% Student-t confidence interval half-width across folds."""
    if isinstance(level, str):
        level = df.index.names.index(level)
    nlevels = df.index.nlevels
    if nlevels == 1 and level is None:
        n = df.shape[0]
        return coef * df.std(ddof=1) / sqrt(n)
    if nlevels == 2 and level is not None:
        n = df.index.levshape[1 - level]
        return coef * df.groupby(level=level).std(ddof=1) / sqrt(n)
    raise ValueError("provide level for multi-level frames")


def consolidate_metrics(scores: list, label: str = "scores",
                        include_metric_types: bool = True) -> pd.DataFrame:
    metric_types = None
    if include_metric_types:
        metric_types = [type(s).__name__.lower() for s in scores]
    frames = [pd.DataFrame([s], index=[label]) for s in scores]
    return pd.concat(frames, keys=metric_types, axis=1)


def evaluate_models(models: Sequence, metrics="all", **kwargs
                    ) -> pd.DataFrame:
    rows = []
    for model in models:
        result = model.evaluate(metric_type=metrics, **kwargs)
        result = result if isinstance(result, list) else [result]
        rows.append(consolidate_metrics(result, label=model.method))
    table = pd.concat(rows, axis=0)
    table.columns.names = ["type", "metric"]
    table.index.names = ["model"]
    return table


def set_topk(models: Sequence, topk: int) -> None:
    for model in models:
        model.topk = topk


def build_models(models: Sequence, force: bool = True) -> None:
    for model in models:
        if force or not model._is_ready:
            model.build()


def consolidate(scores: List[pd.DataFrame], level_name: str,
                level_keys: Iterable) -> pd.DataFrame:
    names = [level_name] + list(scores[0].index.names)
    return pd.concat(scores, axis=0, keys=list(level_keys), names=names)


def _shared_data(models: Sequence):
    data = models[0].data
    if any(model.data is not data for model in models[1:]):
        raise ValueError("all models must share one data model")
    return data


def holdout_test(models: Sequence, holdout_sizes: Sequence[int] = (1,),
                 metrics="all") -> pd.DataFrame:
    """Sweep holdout sizes; each size triggers a data re-split."""
    data = _shared_data(models)
    results = []
    for size in holdout_sizes:
        data.holdout_size = size
        data.update()
        results.append(evaluate_models(models, metrics))
    return consolidate(results, "hsize", holdout_sizes)


def topk_test(models: Sequence, topk_list: Sequence[int] = (10,),
              metrics="all", **kwargs) -> pd.DataFrame:
    """Evaluate at several k, largest first, so the cached recommendation
    lists are sliced rather than recomputed (reference
    ``evaluation_engine.py:104-120`` exploiting ``models.py:423``)."""
    _shared_data(models)
    order = sorted(topk_list, reverse=True)
    results = [evaluate_models(models, metrics, topk=k, **kwargs)
               for k in order]
    table = consolidate(results, "top-n", order)
    return table.sort_index(level="top-n", sort_remaining=False)


def run_cv_experiment(models: Sequence, folds: Optional[Iterable] = None,
                      metrics="all",
                      fold_experiment: Callable = evaluate_models,
                      force_build: bool = True,
                      iterator: Callable = lambda x: x,
                      **kwargs) -> pd.DataFrame:
    """Cross-validation over test folds: each fold re-splits the shared
    data (on_change invalidates every model), rebuilds, then runs
    ``fold_experiment``."""
    if not isinstance(models, (list, tuple)):
        models = [models]
    data = _shared_data(models)
    if folds is None:
        folds = range(1, int(1 / data.test_ratio) + 1)
    folds = list(folds)

    results = []
    for fold in iterator(folds):
        data.test_fold = fold
        data.update()
        build_models(models, force_build)
        results.append(fold_experiment(models, metrics=metrics, **kwargs))
    return consolidate(results, "fold", folds)


def average_results(scores: dict):
    """Average fold-level tables (dict of metric -> MultiIndex frame)."""
    averaged, errors = {}, {}
    for metric, table in scores.items():
        averaged[metric] = table.groupby(level=1).mean().sort_index(axis=1)
        errors[metric] = table.groupby(level=1).std().sort_index(axis=1)
    return averaged, errors


def save_scores(scores: dict, dataset_name: str, experiment_name: str,
                save_folder: Optional[str] = None) -> None:
    import os
    folder = save_folder or "results"
    os.makedirs(folder, exist_ok=True)
    for key, metrics in scores.items():
        for metric, frame in metrics.items():
            path = (f"{folder}/{dataset_name}_{experiment_name}_"
                    f"({key})_{metric}.csv")
            frame.to_csv(path)
