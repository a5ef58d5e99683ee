"""Matplotlib dashboards for experiment results.

Host copy of :mod:`polara_tpu.evaluation.plotting` (reference
``polara/evaluation/plotting.py``): paired metric curves, ROC-style cross
plots with CI bands, and the 2x2 relevance quadrant.  Frames come from
:mod:`polara_tpu_torch.evaluation.engine` consolidation.  matplotlib is
imported by the functions that draw, so this module imports without it.
"""
from __future__ import annotations

from typing import Sequence


def _plt():
    import matplotlib.pyplot as plt
    return plt


def _by_model(frame):
    if "model" in (frame.index.names or ()):
        return frame.unstack("model")
    return frame


def _pair_plot(scores, keys: Sequence[str], titles=None, errors=None,
               err_alpha: float = 0.2, figsize=(16, 5), ax=None):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(1, 2, figsize=figsize)
        show_legend = True
    else:
        show_legend = False
    scores = _by_model(scores)
    left, right = keys
    titles = titles or keys

    scores[left].plot(ax=ax[0], legend=False)
    scores[right].plot(ax=ax[1], legend=False)
    if show_legend:
        plt.legend(loc="center left", bbox_to_anchor=(1.0, 0.5))

    if errors is not None:
        errors = _by_model(errors)
        for side, key in enumerate(keys):
            err = errors[key]
            for method in err.columns:
                center = scores[key][method]
                ax[side].fill_between(err.index, center - err[method],
                                      center + err[method],
                                      alpha=err_alpha, label="std err")
    ax[0].set_ylabel(titles[0])
    ax[1].set_ylabel(titles[1])
    return ax


def _cross_plot(scores, keys: Sequence[str], titles=None, errors=None,
                err_alpha: float = 0.2, diagonal: bool = False,
                figsize=(8, 5), limit=None, ax=None):
    plt = _plt()
    if ax is None:
        fig = plt.figure(figsize=figsize)
        ax = fig.gca()
        show_legend = True
    else:
        show_legend = False
    scores = _by_model(scores)
    x, y = keys
    methods = scores.columns.levels[1]
    for method in methods:
        curve = scores.xs(method, axis=1, level=1).sort_values(x)
        curve.plot.line(x=x, y=y, label=method, ax=ax, legend=False)
    if show_legend:
        plt.legend(loc="center left", bbox_to_anchor=(1.0, 0.5))

    if errors is not None:
        errors = _by_model(errors)
        for method in methods:
            curve = scores.xs(method, axis=1, level=1).sort_values(x)
            err = errors.xs(method, axis=1, level=1).sort_values(x)
            ax.fill_between(curve[x], curve[y] - err[y], curve[y] + err[y],
                            alpha=err_alpha, label="std err")
    if limit:
        if not isinstance(limit, (tuple, list)):
            limit = (0, limit)
        ax.set_xlim(*limit)
        ax.set_ylim(*limit)
    titles = titles or keys
    ax.set_xlabel(titles[0])
    ax.set_ylabel(titles[1])
    if diagonal:
        lims = ax.get_xlim()
        ax.plot(lims, lims, linestyle="--", c="grey")
    return ax


def _section(all_scores, name):
    return all_scores[name] if name in all_scores else all_scores


def _section_errors(kwargs, name):
    errors = kwargs.get("errors")
    kwargs["errors"] = errors[name] if errors is not None else None


def show_hits(all_scores, **kwargs):
    scores = _section(all_scores, "hits")
    _section_errors(kwargs, "hits")
    kwargs["titles"] = ["True Positive Hits @$n$",
                       "False Positive Hits @$n$"]
    return _pair_plot(scores, ["true_positive", "false_positive"], **kwargs)


def show_ranking(all_scores, **kwargs):
    scores = _section(all_scores, "ranking")
    _section_errors(kwargs, "ranking")
    kwargs["titles"] = ["nDCG@$n$", "nDCL@$n$"]
    return _pair_plot(scores, ["ndcg", "ndcl"], **kwargs)


def show_hit_rates(all_scores, **kwargs):
    """ROC-style fallout vs recall."""
    scores = _section(all_scores, "relevance")
    _section_errors(kwargs, "relevance")
    kwargs["titles"] = ["False Positive Rate", "True Positive Rate"]
    kwargs["diagonal"] = True
    kwargs["limit"] = max(scores["fallout"].max().max(),
                          scores["recall"].max().max()) + 0.01
    return _cross_plot(scores, ["fallout", "recall"], **kwargs)


def show_ranking_positivity(all_scores, **kwargs):
    scores = _section(all_scores, "ranking")
    _section_errors(kwargs, "ranking")
    kwargs["titles"] = ["Negative Ranking", "Positive Ranking"]
    kwargs["diagonal"] = True
    kwargs["limit"] = max(scores["ndcl"].max().max(),
                          scores["ndcg"].max().max()) + 0.01
    return _cross_plot(scores, ["ndcl", "ndcg"], **kwargs)


def show_precision_recall(all_scores, limit: bool = False,
                          ignore_field_limit=None, **kwargs):
    scores = _section(all_scores, "relevance")
    _section_errors(kwargs, "relevance")
    kwargs["titles"] = ["Recall", "Precision"]
    if limit:
        maxx = scores["recall"].drop(ignore_field_limit, axis=1,
                                     errors="ignore").max().max()
        maxy = scores["precision"].drop(ignore_field_limit, axis=1,
                                        errors="ignore").max().max()
        kwargs["limit"] = max(maxx, maxy) + 0.05
    return _cross_plot(scores, ["recall", "precision"], **kwargs)


def show_relevance(all_scores, figsize=(16, 10), ax=None):
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(2, 2, figsize=figsize)
    rel = all_scores["relevance"]
    rel["precision"].plot(ax=ax[0, 0], legend=False, title="Precision@$N$")
    rel["recall"].plot(ax=ax[0, 1], legend=False, title="Recall@$N$")
    rel["fallout"].plot(ax=ax[1, 0], legend=False, title="Fallout@$N$")
    rel["miss_rate"].plot(ax=ax[1, 1], legend=False, title="Miss Rate@$N$")
    return ax
