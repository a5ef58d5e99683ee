"""Global configuration registry.

PyTorch counterpart of :mod:`polara_tpu.config`: the same flat registry of
named defaults, with the Pallas switch ``pallas_scoring`` replaced by
``fused_scoring`` (the hand-written CUDA score->mask->top-k kernel), and
the streaming head budget ``streaming_head_gb`` derived from the card's
free memory unless it is set.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable

_DEFAULTS: Dict[str, Any] = dict(
    # properties that require rebuilding test data
    test_ratio=0.2,        # fraction of users reserved for the test fold
    test_fold=5,           # which fold of users to use as the test fold
    shuffle_data=False,    # randomly permute all records in initial data
    test_sample=None,      # cap per-user testset size; negative samples low-rated
    warm_start=True,       # make train and test disjoint by users
    holdout_size=3,        # number of items hidden from each test user
    permute_tops=False,    # shuffle before top selection to break ties randomly
    random_holdout=False,  # sample evaluation items randomly instead of tops
    negative_prediction=False,  # put negative feedback into evaluation set

    # --- models -------------------------------------------------------------
    feedback_threshold=None,
    switch_positive=None,  # feedback below this value counts as negative
    verify_integrity=True,
    svd_rank=10,
    mlrank=(13, 10, 2),
    growth_tol=1e-4,
    num_iters=25,
    show_output=False,
    flattener=slice(0, None),

    # --- recommendations ----------------------------------------------------
    topk=10,
    filter_seen=True,

    # --- evaluation ---------------------------------------------------------
    ndcg_alternative=True,  # exponential instead of linear relevance in nDCG

    # --- computation --------------------------------------------------------
    score_block_users=4096,     # test-user rows per scoring block
    hbm_score_budget_gb=4.0,    # soft cap for a single score block on device
    compute_dtype="float32",    # dtype of device-side factor/score math
    # fused score->mask->top-k kernel (ops/fused_topk.py): "auto" uses it
    # for factor models on CUDA tensors when topk <= 128 and the unfused
    # path on the CPU; True forces the fused route (its plain version on
    # the CPU); False always takes the unfused path
    fused_scoring="auto",
    # fused-route item layout: "popularity" permutes the item panel to
    # descending interaction count (equal-score ties resolve toward the
    # popular item).  None keeps catalog order.
    fused_item_order="popularity",
    # beyond-memory streaming tier (models/svd.py past the budget): route
    # the Zipf head of the event stream through a dense (users x P) block
    # (ops/sparse.py:split_coo_operator) instead of the tiled gathers; the
    # split declines by itself when item margins are too flat to pay
    streaming_split_head=True,
    # the head block's budget in GiB; None: a quarter of the free device
    # memory (torch.cuda.mem_get_info) on the operator's card at staging,
    # and the JAX package's 2.0 on the CPU
    # (ops/sparse.py:resolve_head_budget)
    streaming_head_gb=None,
)


def get_config(params: Iterable[str]) -> Dict[str, Any]:
    """Return ``{name: default}`` for the requested parameter names."""
    return {name: _DEFAULTS[name] for name in params}


def get_default(name: str) -> Any:
    return _DEFAULTS[name]


def set_default(name: str, value: Any) -> None:
    """Override a global default (affects objects created afterwards)."""
    if name not in _DEFAULTS:
        raise KeyError(f"Unknown config parameter: {name!r}")
    _DEFAULTS[name] = value


def defaults_snapshot() -> Dict[str, Any]:
    return dict(_DEFAULTS)
