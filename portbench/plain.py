"""Plain reference pieces shared by every configuration's reference.

Nothing here imports the program.  From the benchmark's own events and
holdout, :class:`Problem` works out again what the program's data model
derives (polara's reindexing and consistency rules), and the functions
below judge what the program produced: its top-k picks, re-scored in f64
from its own factors, and its metric values, recomputed in numpy from its
picks by polara's definitions.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

F64 = torch.float64


class Problem(NamedTuple):
    """The scenario after polara's split: known users, every user with a
    held-out event tested, seen items masked."""
    n_users: int             # training users (internal ids 0..n_users-1)
    n_items: int             # training items (internal ids 0..n_items-1)
    rows: np.ndarray         # training events, internal user ids, sorted
    cols: np.ndarray         # training events, internal item ids
    vals: np.ndarray         # training ratings (float64)
    test_users: np.ndarray   # internal ids of the tested users, ascending
    hold_items: np.ndarray   # (n_test,) internal id of each one's holdout
    hold_vals: np.ndarray    # (n_test,) its rating
    user_start: np.ndarray   # (n_users + 1,) offsets of each user's events


def make_problem(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 hold: np.ndarray) -> Problem:
    """The split as polara's data model makes it from training events
    ``~hold`` and holdout events ``hold``: users indexed in order of first
    appearance in the training events, items in ascending id order;
    holdout events whose user or item is absent from training dropped."""
    t_rows, t_cols, t_vals = rows[~hold], cols[~hold], vals[~hold]
    users, first = np.unique(t_rows, return_index=True)
    code = np.empty(len(users), dtype=np.int64)       # sorted id -> code
    code[np.argsort(first, kind="stable")] = np.arange(len(users))
    items = np.unique(t_cols)
    r = code[np.searchsorted(users, t_rows)]
    c = np.searchsorted(items, t_cols)
    order = np.argsort(r, kind="stable")
    r, c, v = r[order], c[order], t_vals[order]

    h_rows, h_cols, h_vals = rows[hold], cols[hold], vals[hold]
    ipos = np.searchsorted(items, h_cols).clip(max=len(items) - 1)
    upos = np.searchsorted(users, h_rows).clip(max=len(users) - 1)
    keep = (items[ipos] == h_cols) & (users[upos] == h_rows)
    h_user = code[upos[keep]]
    if len(np.unique(h_user)) != len(h_user):
        raise ValueError("the plain reference takes one held-out event per "
                         "user")
    order = np.argsort(h_user, kind="stable")
    start = np.zeros(len(users) + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=len(users)), out=start[1:])
    return Problem(n_users=len(users), n_items=len(items), rows=r, cols=c,
                   vals=v, test_users=h_user[order],
                   hold_items=ipos[keep][order],
                   hold_vals=h_vals[keep][order], user_start=start)


def dense_rows(problem: Problem, users: np.ndarray, device,
               dtype=F64) -> torch.Tensor:
    """The training ratings of ``users`` as a dense (len(users), n_items)
    block on ``device``."""
    lo, hi = problem.user_start[users], problem.user_start[users + 1]
    counts = hi - lo
    # each user's events in turn: lo_u, lo_u + 1, ..., hi_u - 1
    take = np.repeat(lo - np.cumsum(np.r_[0, counts[:-1]]), counts) + \
        np.arange(counts.sum())
    local = np.repeat(np.arange(len(users)), counts)
    block = torch.zeros((len(users), problem.n_items), dtype=dtype,
                        device=device)
    block[torch.as_tensor(local, device=device),
          torch.as_tensor(problem.cols[take], device=device)] = \
        torch.as_tensor(problem.vals[take], dtype=dtype, device=device)
    return block


def user_blocks(n: int, size: int = 8192):
    for lo in range(0, n, size):
        yield lo, min(lo + size, n)


def judge_picks(problem: Problem, recs: np.ndarray,
                scores_of: Callable[[np.ndarray], torch.Tensor],
                k: int, device) -> Dict[str, float]:
    """The picks of every tested user against f64 scores of the same
    factors (``scores_of(test_rows)`` -> (rows, n_items)).

    ``pick_gap``: the widest gap by which a pick's score lies below the
    user's k-th best unseen score, over the user's best unseen score.
    ``bad_picks``: picks out of range, seen, repeated in a row, or missing
    where the user has k unseen items."""
    recs = np.asarray(recs, dtype=np.int64)
    if recs.shape != (len(problem.test_users), k):
        return {"pick_gap": float("inf"), "bad_picks": float(recs.size)}
    gap, bad = 0.0, 0
    for lo, hi in user_blocks(len(problem.test_users)):
        users = problem.test_users[lo:hi]
        scores = scores_of(np.arange(lo, hi)).to(F64)
        seen = dense_rows(problem, users, device,
                          dtype=torch.float32) != 0
        unseen = scores.masked_fill(seen, -torch.inf)
        top = torch.topk(unseen, k, dim=1).values
        kth = top[:, -1]
        scale = top[:, 0].abs().clamp(min=1e-300)
        picks = torch.as_tensor(recs[lo:hi], device=device)
        valid = (picks >= 0) & (picks < problem.n_items)
        safe = picks.clamp(0, problem.n_items - 1)
        n_unseen = (~seen).sum(1)
        missing = (~valid) & (picks == -1) & (n_unseen[:, None] >= k)
        out_of_range = (~valid) & (picks != -1)
        is_seen = valid & seen.gather(1, safe)
        ordered = torch.sort(torch.where(valid, picks, -1 - torch.arange(
            k, device=device)[None, :]), dim=1).values
        repeated = (ordered[:, 1:] == ordered[:, :-1]) & (ordered[:, 1:] >= 0)
        bad += int(missing.sum() + out_of_range.sum() + is_seen.sum()
                   + repeated.sum())
        picked = unseen.gather(1, safe)
        lag = torch.where(valid & ~is_seen, (kth[:, None] - picked)
                          .clamp(min=0) / scale[:, None], 0.0)
        gap = max(gap, float(lag.max()))
    return {"pick_gap": gap, "bad_picks": float(bad)}


def metrics(problem: Problem, recs: np.ndarray, dtype=np.float64
            ) -> Dict[str, float]:
    """polara's metric families for one held-out event per user, in the
    implicit regime (every unrated pick a false positive) with
    exponential nDCG gain, from the picks ``recs`` (rows = tested users,
    -1 = no pick), computed in ``dtype``."""
    recs = np.asarray(recs, dtype=np.int64)
    n, k = recs.shape
    one = dtype(1)
    valid = recs >= 0
    hit = (recs == problem.hold_items[:, None]) & valid
    found = hit.any(1)
    rank = np.where(found, hit.argmax(1) + 1, 0)
    tp = found.astype(dtype)
    n_recs = valid.sum(1).astype(dtype)
    fp = n_recs - tp
    fn = one - tp
    safe = lambda num, den, mask: np.where(mask, num / np.where(mask, den,
                                                                one), 0)
    precision = safe(tp, tp + fp, tp > 0).astype(dtype).mean(dtype=dtype)
    recall = safe(tp, tp + fn, tp > 0).astype(dtype).mean(dtype=dtype)
    miss_rate = safe(fn, fn + tp, fn > 0).astype(dtype).mean(dtype=dtype)
    recip = np.where(found, one / np.maximum(rank, 1).astype(dtype), 0)
    arhr = recip.astype(dtype).mean(dtype=dtype)
    # one relevant item: MAP@k is its reciprocal rank, nDCG its discount
    mean_ap = arhr
    gain = np.exp2(problem.hold_vals.astype(dtype)) - one
    disc = np.where(found, one / np.log2(one + np.maximum(rank, 1)
                                         .astype(dtype)), 0)
    dcg = gain * disc
    idcg = gain * one           # the ideal position is 1: 1/log2(2)
    ndcg = np.where(dcg > 0, dcg / np.where(dcg > 0, idcg, one), 0)
    ndcg = ndcg.astype(dtype).mean(dtype=dtype)
    in_catalog = recs[valid & (recs < problem.n_items)]
    coverage = dtype(len(np.unique(in_catalog))) / dtype(problem.n_items)
    return {"precision": precision, "recall": recall,
            "miss_rate": miss_rate, "ndcg": ndcg, "map": mean_ap,
            "arhr": arhr, "coverage": coverage,
            "true_positive": tp.sum(dtype=dtype),
            "false_positive": fp.sum(dtype=dtype),
            "false_negative": fn.sum(dtype=dtype)}


def metric_gap(program: Dict[str, float], reference: Dict[str, float]
               ) -> float:
    """The widest relative gap between the program's metric values and the
    reference's; a metric the program lacks or adds counts as infinite."""
    if set(program) != set(reference):
        return float("inf")
    gap = 0.0
    for name, ref in reference.items():
        got = float(program[name])
        ref = float(ref)
        if not np.isfinite(got):
            return float("inf")
        gap = max(gap, abs(got - ref) / max(abs(ref), 1e-300)
                  if ref else abs(got))
    return gap
