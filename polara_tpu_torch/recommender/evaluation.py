"""Alias of :mod:`polara_tpu_torch.evaluation.metrics` matching the
reference import path (``polara.recommender.evaluation``)."""
from polara_tpu_torch.evaluation.metrics import *        # noqa: F401,F403
from polara_tpu_torch.evaluation.metrics import (        # noqa: F401
    build_holdout_arrays, compute_metrics, convert_scores_to_series,
    get_arhr_score, get_experience_scores, get_hits, get_hr_score,
    get_map_score, get_mrr_score, get_ndcg_score, get_ndcl_score,
    get_ranking_scores, get_relevance_scores, get_rr_scores)
