"""Hyper-parameter search pipelines.

Counterpart of :mod:`polara_tpu.evaluation.pipelines` (reference
``polara/evaluation/pipelines.py``).  The structural trick: factor models
are built once at the **largest** requested rank and evaluated downward by
truncating cached factors — turning a rank sweep into one build + cheap
re-scorings (for the CoFFee model, :func:`find_optimal_tucker_ranks`,
by rounding its Tucker core).
"""
from __future__ import annotations

import random as _random
from collections import abc
from functools import reduce
from operator import mul
from typing import Callable, Dict, Optional, Sequence, Tuple

import pandas as pd
import torch


def is_list_like(obj, allow_sets: bool = False) -> bool:
    return (isinstance(obj, abc.Iterable)
            and not isinstance(obj, (str, bytes))
            and (allow_sets or not isinstance(obj, abc.Set))
            and not isinstance(obj, abc.Mapping))


def random_grid(params: Dict[str, Sequence], n: int = 60,
                grid_cache=None, skip_config: Optional[Callable] = None,
                seed: Optional[int] = None) -> Tuple[set, tuple]:
    """Sample up to n distinct configurations from a parameter grid."""
    if not isinstance(n, int):
        raise TypeError(f"n must be an integer, not {type(n)}")
    if n < 0:
        raise ValueError("n should be >= 0")
    param_names, param_values = zip(*params.items())
    grid = set(grid_cache) if grid_cache is not None else set()
    max_n = reduce(mul, (len(vals) for vals in param_values))
    n = min(n if n > 0 else max_n, max_n)
    skip_config = skip_config or (lambda config: False)
    rng = _random.Random(seed)

    skipped = set()
    while len(grid) < n - len(skipped):
        pick = tuple(rng.choice(list(vals)) for vals in param_values)
        if skip_config(pick):
            skipped.add(pick)
            continue
        grid.add(pick)
    return grid, param_names


def set_config(model, config: Dict, convert_nan: bool = True) -> None:
    for name, value in config.items():
        if convert_nan and value != value:  # NaN from pandas grids
            value = None
        setattr(model, name, value)


def evaluate_models(models, target_metric: str = "precision",
                    metric_type="all", **kwargs) -> Dict[str, float]:
    """Per-model scalar score for the tuning target."""
    if not is_list_like(models, allow_sets=True):
        models = [models]
    out = {}
    for model in models:
        scores = model.evaluate(metric_type, **kwargs)
        scores = scores if isinstance(scores, list) else [scores]
        table = pd.concat([pd.DataFrame([s]) for s in scores], axis=1)
        if isinstance(target_metric, str):
            out[model.method] = table[target_metric].squeeze()
        elif callable(target_metric):
            out[model.method] = table.apply(target_metric,
                                            axis=1).squeeze()
        else:
            raise TypeError("target_metric must be a name or callable")
    return out


def _mask_trailing_columns(factor, rank: int):
    """Zero the columns at and beyond ``rank``, keeping the shape."""
    cols = torch.arange(factor.shape[-1], device=factor.device)
    return factor * (cols < rank).to(factor.dtype)


def find_optimal_svd_rank(model, ranks: Sequence[int], target_metric,
                          return_scores: bool = False,
                          protect_factors: bool = True,
                          config: Optional[Dict] = None,
                          verbose: bool = False,
                          evaluator: Optional[Callable] = None,
                          iterator: Callable = lambda x: x,
                          pad_to_top_rank: bool = True, **kwargs):
    """Rank sweep via one max-rank build + factor truncation
    (reference ``pipelines.py:89-118`` + ``models.py:819-832``).

    With ``pad_to_top_rank`` (default) truncated factors are zero-padded
    back to the top rank, as in the JAX package (where it saves a compile
    per rank): the trailing zero columns contribute nothing to
    ``proj @ panelᵀ``.  In the fused kernel each score is an ``fmaf``
    chain from 0, so a zero term leaves it exact and the padded picks
    equal the truncated ones bit for bit; cuBLAS may block differently
    with the width, so the unfused route's sums may differ in the last
    bit.  Zero-masking is only score-neutral for the SVD family
    (orthogonal factor truncation); for other factor models the sweep
    rebuilds at each rank via the rank setter.
    """
    evaluator = evaluator or evaluate_models
    model_verbose = model.verbose
    if config:
        set_config(model, config)

    model.rank = top_rank = max(max(ranks), model.rank)
    if not model._is_ready:
        model.verbose = verbose
        model.build()
    saved_factors = dict(**model.factors) if protect_factors else None
    from polara_tpu_torch.models.svd import SVDModel
    # Zero-masking bypasses the rank setter's _check_reduced_rank hook.
    # Subclasses that override the hook keep derived state in sync with the
    # truncated factors (cold-start mixins recompute the pinv-gram feature
    # transform; HybridSVD re-slices projectors) — masking would leave that
    # state at full rank, silently diverging from true truncation.  Such
    # models take the setter path.
    overrides_rank_hook = (type(model)._check_reduced_rank
                           is not SVDModel._check_reduced_rank)
    pad_to_top_rank = (pad_to_top_rank and protect_factors
                       and isinstance(model, SVDModel)
                       and not overrides_rank_hook)

    def set_rank(rank: int) -> None:
        if not pad_to_top_rank:
            model.rank = rank
            return
        model._rank = rank
        padded = {}
        for key, factor in saved_factors.items():
            if (factor is not None and hasattr(factor, "shape")
                    and factor.ndim >= 1 and factor.shape[-1] == top_rank
                    and rank < top_rank):
                factor = _mask_trailing_columns(factor, rank)
            padded[key] = factor
        model.factors = padded
        model._recommendations = None

    results = {}
    try:
        for rank in iterator(sorted(ranks, reverse=True)):
            set_rank(rank)
            results[rank] = evaluator(model, target_metric,
                                      **kwargs)[model.method]
            model._recommendations = None
    finally:
        if protect_factors:
            model._rank = top_rank
            model.factors = saved_factors
            # resync derived state with the restored full-rank factors:
            # subclasses keep rank-dependent caches (cold-start pinv-gram,
            # hybrid projector slices) that the per-rank loop left at the
            # last swept rank
            model._check_reduced_rank(top_rank)
        model.verbose = model_verbose

    scores = pd.Series(results)
    best_rank = scores.idxmax()
    if return_scores:
        scores.index.name = "rank"
        scores.name = model.method
        return best_rank, scores.loc[list(ranks)]
    return best_rank


def find_optimal_tucker_ranks(model, tucker_ranks: Sequence[Sequence[int]],
                              target_metric, return_scores: bool = False,
                              config: Optional[Dict] = None,
                              verbose: bool = False,
                              same_space: bool = False,
                              evaluator: Optional[Callable] = None,
                              iterator: Callable = lambda x: x, **kwargs):
    """Multilinear rank sweep via one max-rank build + core rounding.

    Skips infeasible cores violating the rank triangle inequality
    (r_i * r_j >= r_k), reference ``pipelines.py:141-143``.
    """
    evaluator = evaluator or evaluate_models
    model_verbose = model.verbose
    if config:
        set_config(model, config)

    model.mlrank = tuple(max(r) for r in tucker_ranks)
    if not model._is_ready:
        model.verbose = verbose
        model.build()
    saved_factors = dict(**model.factors)
    top_mlrank = model.mlrank

    results = {}
    for r1 in iterator(tucker_ranks[0]):
        for r2 in tucker_ranks[1]:
            if same_space and r2 != r1:
                continue
            for r3 in tucker_ranks[2]:
                if r1 * r2 < r3 or r1 * r3 < r2 or r2 * r3 < r1:
                    continue
                try:
                    model.mlrank = (r1, r2, r3)
                    results[(r1, r2, r3)] = evaluator(
                        model, target_metric, **kwargs)[model.method]
                    model._recommendations = None
                finally:
                    model._mlrank = top_mlrank
                    model.factors = dict(**saved_factors)
    model.verbose = model_verbose

    scores = pd.Series(results).sort_index()
    best_mlrank = scores.idxmax()
    if return_scores:
        scores.index.names = ["r1", "r2", "r3"]
        scores.name = model.method
        return best_mlrank, scores
    return best_mlrank


def params_to_dict(names, params) -> Dict:
    if is_list_like(params):
        return dict(zip(names, params))
    return {names: params}


def find_optimal_config(model, param_grid, param_names, target_metric,
                        return_scores: bool = False,
                        init_config=None, reset_config=None,
                        verbose: bool = False, force_build: bool = True,
                        evaluator: Optional[Callable] = None,
                        iterator: Callable = lambda x: x, **kwargs):
    """Generic grid search with full rebuilds per configuration
    (reference ``pipelines.py:170-214``)."""
    evaluator = evaluator or evaluate_models
    model_verbose = model.verbose
    if init_config:
        if not is_list_like(init_config):
            init_config = [init_config]
        for config in init_config:
            set_config(model, config)

    model.verbose = verbose
    results = {}
    for params in iterator(param_grid):
        try:
            set_config(model, params_to_dict(param_names, params))
            if force_build or not model._is_ready:
                model.build()
            results[params] = evaluator(model, target_metric,
                                        **kwargs)[model.method]
        finally:
            if reset_config is not None:
                if isinstance(reset_config, dict):
                    set_config(model, reset_config)
                elif callable(reset_config):
                    reset_config(model)
                else:
                    raise TypeError("reset_config must be dict or callable")
    model.verbose = model_verbose

    keys, values = zip(*results.items())
    scores = pd.Series(index=keys, data=values)
    best_params = scores.idxmax()
    best_config = params_to_dict(param_names, best_params)
    if return_scores:
        try:
            scores.index.names = param_names
        except ValueError:
            scores.index.name = param_names
        scores.name = model.method
        return best_config, scores
    return best_config
