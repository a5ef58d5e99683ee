"""Polarity-aware evaluation metrics: the one-pass metric engine.

Counterpart of :mod:`polara_tpu.evaluation.metrics` (the reference engine
``polara/recommender/evaluation.py:23-253``): with per-user padded holdout
lists ``(n_users, h)`` and recommendations ``(n_users, k)``, the membership
test ``recs[:, None, :] == holdout[:, :, None]`` yields every hit rank in
one vectorized pass, and all metric families reduce from it.
:func:`metrics_core` works on tensors on any device, in f64; only
:func:`build_holdout_arrays` and :func:`compute_metrics` take the pandas
holdout frame.

Parity notes carried over: masked-out entries contribute 0
(``safe_divide``), and coverage counts only valid recommendations (the
reference's ``np.unique`` would count the -1 padding).
"""
from __future__ import annotations

from collections import namedtuple
from typing import Dict, Optional

import numpy as np
import torch

Relevance = namedtuple("Relevance", ["precision", "recall", "fallout",
                                     "specifity", "miss_rate"])
SimpleRelevance = namedtuple("Relevance", ["hr"])
Ranking = namedtuple("Ranking", ["ndcg", "ndcl", "map", "arhr"])
SimpleRanking = namedtuple("Ranking", ["arhr", "mrr"])
Hits = namedtuple("Hits", ["true_positive", "false_positive",
                           "true_negative", "false_negative"])
Experience = namedtuple("Experience", ["coverage"])


def build_holdout_arrays(holdout, key: str, target: str,
                         feedback: Optional[str] = None,
                         return_positions: bool = False):
    """Pack a key-sorted holdout frame into padded per-key numpy arrays
    ``(items, feedback_values, valid_mask)``, each (n_keys, h_max), plus
    the per-event (keys, positions) placement with ``return_positions``.
    Keys are rebased to 0..n_keys-1 by order of appearance, aligned with
    the recommendation rows."""
    import pandas as pd

    keys = pd.factorize(holdout[key], sort=False)[0]
    n_keys = int(keys.max()) + 1 if len(keys) else 0
    counts = np.bincount(keys, minlength=n_keys)
    width = max(1, int(counts.max()) if counts.size else 1)
    offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))
    positions = np.arange(len(keys)) - np.repeat(offsets, counts)

    items = np.full((n_keys, width), -1, dtype=np.int64)
    fb = np.zeros((n_keys, width), dtype=np.float64)
    valid = np.zeros((n_keys, width), dtype=bool)
    items[keys, positions] = holdout[target].values
    if feedback is not None:
        fb[keys, positions] = holdout[feedback].values.astype(np.float64)
    else:
        fb[keys, positions] = 1.0
    valid[keys, positions] = True
    if return_positions:
        return items, fb, valid, keys, positions
    return items, fb, valid


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def metrics_core(recs: torch.Tensor, items: torch.Tensor, fb: torch.Tensor,
                 valid: torch.Tensor, is_pos: torch.Tensor, topk: int,
                 switch_positive: float, alternative: bool, has_split: bool,
                 penalty: float, coverage_total: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """All metric families from recommendations ``recs`` (n_users, k) and
    the padded holdout ``items``/``fb``/``valid``/``is_pos``
    (n_users, h), as f64 scalar tensors on the inputs' device."""
    f = torch.float64
    recs = recs.long()
    items = items.long()
    fb = fb.to(f)

    # hit ranks: 1-based position of each holdout item in the user's recs
    match = ((recs[:, None, :] == items[:, :, None])
             & (recs >= 0)[:, None, :] & valid[:, :, None])
    found = match.any(-1)
    rank = torch.where(found, _first_true(match) + 1, 0)    # (n_users, h)

    pos_entry = valid & is_pos
    neg_entry = (valid & ~is_pos) if has_split else torch.zeros_like(valid)
    pos_rank = torch.where(pos_entry, rank, 0)
    neg_rank = torch.where(neg_entry, rank, 0)
    pos_hit = pos_rank > 0
    neg_hit = neg_rank > 0

    # --- counting stats (reference get_relevance_data, evaluation.py:190) --
    n_recs = (recs >= 0).sum(1).to(f)
    tp = pos_hit.sum(1).to(f)
    n_eval = valid.sum(1).to(f)
    if has_split:
        fp = neg_hit.sum(1).to(f)
        tn = neg_entry.sum(1).to(f) - fp
        fn = pos_entry.sum(1).to(f) - tp
        if penalty > 0:
            fp = fp + penalty * (n_recs - tp - fp)
    else:
        fp = (penalty * (n_recs - tp)) if penalty > 0 \
            else torch.zeros_like(tp)
        tn = torch.zeros_like(tp)
        fn = n_eval - tp

    def ratio_mean(num, den, mask):
        return torch.where(mask, num / torch.where(mask, den, 1.0),
                           0.0).mean()

    tpnz, fnnz = tp > 0, fn > 0
    precision = ratio_mean(tp, tp + fp, tpnz)
    recall = ratio_mean(tp, tp + fn, tpnz)
    miss_rate = ratio_mean(fn, fn + tp, fnnz)
    fallout = ratio_mean(fp, fp + tn, fp > 0)
    specifity = ratio_mean(tn, fp + tn, tn > 0)

    # --- simple rates (evaluation.py:101-118) ------------------------------
    hr = tp.mean()
    recip = torch.where(pos_hit, 1.0 / pos_rank.clamp(min=1).to(f), 0.0)
    arhr = recip.sum(1).mean()
    mrr = recip.max(1).values.mean()

    # --- MAP@k (evaluation.py:120-133) -------------------------------------
    # the precision at each hit, summed over the k recommendation slots:
    # every positive holdout entry ranked at slot j (m_j of them, more than
    # one when a row's holdout repeats an item) counts the hit entries
    # ranked at or above it, cumsum(m)_j, over j.  That is the JAX
    # package's per-entry sum (recommendations are unique) without its
    # (users, h, h) comparison, which asks O(users·h²) memory (terabytes
    # for the item cold-start holdout, h ~ 3e4 events per cold item)
    slot_hits = (match & pos_entry[:, :, None]).sum(1).to(f)     # (n, k)
    hits_upto = torch.cumsum(slot_hits, dim=1)
    slot_rank = torch.arange(1, recs.shape[1] + 1, dtype=f,
                             device=recs.device)
    prec_at = slot_hits * hits_upto / slot_rank
    n_rel_adj = torch.clamp(n_eval, max=float(topk))
    mean_ap = (prec_at.sum(1) / n_rel_adj.clamp(min=1.0)).mean()

    # --- nDCG / nDCL (evaluation.py:136-174) -------------------------------
    sort_key = torch.where(valid, fb, -torch.inf)
    order = torch.argsort(sort_key, dim=1, stable=True, descending=True)
    ideal_pos = torch.argsort(order, dim=1, stable=True) + 1   # 1-based
    disc = torch.where(rank > 0,
                       1.0 / torch.log2(1.0 + rank.clamp(min=1).to(f)), 0.0)
    ideal_disc = 1.0 / torch.log2(1.0 + ideal_pos.to(f))

    def ndcr(entry_mask, rel):
        rel = torch.where(entry_mask, rel, 0.0)
        dcr = (rel * disc).sum(1)
        idcr = (rel * ideal_disc).sum(1)
        good = dcr > 0
        return torch.where(good, dcr / torch.where(good, idcr, 1.0),
                           0.0).mean()

    gain = (torch.exp2(fb) - 1.0) if alternative else fb
    ndcg = ndcr(pos_entry, gain)
    if has_split:
        shifted = fb - switch_positive
        # negative relevance with negated discounts (evaluation.py:171-174);
        # flipping both signs keeps the ratio
        loss = -(torch.exp2(shifted) - 1.0) if alternative else -shifted
        ndcl = ndcr(neg_entry, loss)
    else:
        ndcl = torch.tensor(torch.nan, dtype=f, device=recs.device)

    out = dict(
        hr=hr, arhr=arhr, mrr=mrr, map=mean_ap, ndcg=ndcg, ndcl=ndcl,
        precision=precision, recall=recall, miss_rate=miss_rate,
        fallout=fallout, specifity=specifity,
        tp=tp.sum(), fp=fp.sum(), tn=tn.sum(), fn=fn.sum(),
    )
    if coverage_total:
        # catalog coverage: padding and ids beyond the catalog excluded
        valid_rec = (recs >= 0) & (recs < coverage_total)
        hit = torch.bincount(recs[valid_rec], minlength=coverage_total) > 0
        out["coverage"] = hit.sum().to(f) / coverage_total
    return out


def compute_metrics(recommendations, holdout, key: str, target: str,
                    feedback: Optional[str] = None,
                    is_positive: Optional[np.ndarray] = None,
                    switch_positive: Optional[float] = None,
                    not_rated_penalty: float = 0.0,
                    topk: Optional[int] = None,
                    alternative: bool = True,
                    coverage_total: Optional[int] = None
                    ) -> Dict[str, float]:
    """All metric families at once from a recommendation panel (numpy or a
    tensor, which stays on its device) and the holdout frame; returns a
    flat dict of floats (one device->host copy)."""
    if isinstance(recommendations, torch.Tensor):
        recs = recommendations
    else:
        recs = torch.as_tensor(np.asarray(recommendations))
    if recs.dim() == 1:
        recs = recs[None, :]
    device = recs.device
    items, fb, valid, keys, positions = build_holdout_arrays(
        holdout, key, target, feedback, return_positions=True)
    if recs.shape[0] != items.shape[0]:
        raise ValueError(
            f"{recs.shape[0]} recommendation rows vs {items.shape[0]} "
            f"holdout keys — data is misaligned")
    has_split = is_positive is not None
    if has_split:
        is_pos = np.zeros_like(valid)
        is_pos[keys, positions] = np.asarray(is_positive)
    else:
        is_pos = valid

    def to_dev(array):
        return torch.as_tensor(array).to(device)

    out = metrics_core(
        recs, to_dev(items), to_dev(fb), to_dev(valid), to_dev(is_pos),
        topk=int(topk if topk is not None else recs.shape[1]),
        switch_positive=float(switch_positive or 0.0),
        alternative=bool(alternative), has_split=has_split,
        penalty=float(not_rated_penalty),
        coverage_total=int(coverage_total or 0))
    names = list(out)
    stacked = torch.stack([out[name] for name in names]).cpu().numpy()
    return {name: float(value) for name, value in zip(names, stacked)}


def get_experience_scores(recommendations, total: int) -> Experience:
    """Catalog coverage of a recommendation panel (padding excluded)."""
    if isinstance(recommendations, torch.Tensor):
        recommendations = recommendations.cpu().numpy()
    recs = np.asarray(recommendations)
    unique = np.unique(recs[recs >= 0])
    return Experience(coverage=len(unique) / total)


def convert_scores_to_series(metrics, name: str = "scores"):
    """Namedtuple list -> pandas Series (reference ``evaluation.py:256``)."""
    import pandas as pd

    if not isinstance(metrics, list):
        metrics = [metrics]
    records = []
    for tup in metrics:
        records.extend(tup._asdict().items())
    frame = pd.DataFrame.from_records(records, columns=["metric", name])
    return frame.set_index("metric")[name]


# --------------------------------------------------------------------------
# Reference-style per-family accessors (evaluation.py:101-253): each is a
# view over the one-pass metric engine, taking the raw
# (recommendations, holdout) pair.
# --------------------------------------------------------------------------

# One-entry memo over the metric pass: reference-style call sequences
# (``get_ranking_scores`` then ``get_relevance_scores`` on the same recs)
# pay one pass, not one per family.  Keyed on argument identity (strong
# refs retained, so ids cannot be recycled).
_family_memo: dict = {}


def _memo_token(v):
    """Hash/compare-safe token: plain scalars by value, everything else
    (pandas Series, lists, arrays) by identity."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return id(v)


def _array_token(v):
    """Identity plus a 64-element strided content sample for host arrays
    (catches in-place mutation between calls).  Tensors count by identity:
    sampling one on the card would cost a device->host sync."""
    if isinstance(v, np.ndarray) and v.size:
        idx = np.linspace(0, v.size - 1, num=min(64, v.size),
                          dtype=np.int64)
        return (id(v), v.shape, v.flat[idx].tobytes())
    return id(v)


def _family(recommendations, holdout, key, target, **kwargs):
    arrays = {k: v for k, v in kwargs.items()
              if isinstance(v, (np.ndarray, torch.Tensor))}
    others = {k: v for k, v in kwargs.items() if k not in arrays}
    scalars = tuple(sorted((k, _memo_token(v)) for k, v in others.items()))
    memo_key = ((_array_token(recommendations), id(holdout))
                + tuple(_array_token(v) for _, v in sorted(arrays.items())),
                key, target, tuple(sorted(arrays)), scalars)
    if _family_memo.get("key") == memo_key:
        return _family_memo["value"]
    value = compute_metrics(recommendations, holdout, key, target, **kwargs)
    _family_memo.update(
        key=memo_key, value=value,
        refs=(recommendations, holdout, tuple(arrays.values()),
              tuple(others.values())))
    return value


def get_hr_score(recommendations, holdout, key, target, **kwargs):
    return SimpleRelevance(hr=_family(recommendations, holdout, key,
                                      target, **kwargs)["hr"])


def get_rr_scores(recommendations, holdout, key, target, **kwargs):
    stats = _family(recommendations, holdout, key, target, **kwargs)
    return SimpleRanking(arhr=stats["arhr"], mrr=stats["mrr"])


def get_arhr_score(recommendations, holdout, key, target, **kwargs):
    return _family(recommendations, holdout, key, target,
                   **kwargs)["arhr"]


def get_mrr_score(recommendations, holdout, key, target, **kwargs):
    return _family(recommendations, holdout, key, target, **kwargs)["mrr"]


def get_map_score(recommendations, holdout, key, target, **kwargs):
    return _family(recommendations, holdout, key, target, **kwargs)["map"]


def get_ndcg_score(recommendations, holdout, key, target, **kwargs):
    return _family(recommendations, holdout, key, target, **kwargs)["ndcg"]


def get_ndcl_score(recommendations, holdout, key, target, **kwargs):
    return _family(recommendations, holdout, key, target, **kwargs)["ndcl"]


def get_ranking_scores(recommendations, holdout, key, target, **kwargs):
    stats = _family(recommendations, holdout, key, target, **kwargs)
    return Ranking(ndcg=stats["ndcg"], ndcl=stats["ndcl"],
                   map=stats["map"], arhr=stats["arhr"])


def get_relevance_scores(recommendations, holdout, key, target, **kwargs):
    stats = _family(recommendations, holdout, key, target, **kwargs)
    return Relevance(precision=stats["precision"], recall=stats["recall"],
                     fallout=stats["fallout"], specifity=stats["specifity"],
                     miss_rate=stats["miss_rate"])


def get_hits(recommendations, holdout, key, target, **kwargs):
    stats = _family(recommendations, holdout, key, target, **kwargs)
    return Hits(true_positive=stats["tp"], false_positive=stats["fp"],
                true_negative=stats["tn"], false_negative=stats["fn"])
