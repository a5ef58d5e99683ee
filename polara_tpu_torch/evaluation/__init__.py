"""Metric engine (torch + numpy), and the pandas-side experiment tier:
``engine`` (cross-validation, top-k and holdout sweeps), ``pipelines``
(rank and configuration search) and ``plotting``.  The pandas tier loads
on first use of one of its names, so importing this package needs neither
pandas nor matplotlib."""
from polara_tpu_torch.evaluation.metrics import (
    Experience, Hits, Ranking, Relevance, SimpleRanking, SimpleRelevance,
    build_holdout_arrays, compute_metrics, convert_scores_to_series,
    get_experience_scores, metrics_core)

_LAZY = {
    "run_cv_experiment": "engine", "topk_test": "engine",
    "holdout_test": "engine", "evaluate_models": "engine",
    "consolidate_metrics": "engine", "average_results": "engine",
    "find_optimal_svd_rank": "pipelines",
    "find_optimal_tucker_ranks": "pipelines",
    "find_optimal_config": "pipelines", "random_grid": "pipelines",
}

__all__ = ["Relevance", "SimpleRelevance", "Ranking", "SimpleRanking",
           "Hits", "Experience", "build_holdout_arrays", "compute_metrics",
           "convert_scores_to_series", "get_experience_scores",
           "metrics_core", *_LAZY]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
