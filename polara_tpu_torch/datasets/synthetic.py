"""Synthetic interaction generators (counterpart of
:mod:`polara_tpu.datasets.synthetic`).

:func:`make_synthetic_interactions`, :func:`make_realistic_coo` and
:func:`make_realistic_interactions` are the JAX package's numpy
generators, draw for draw (``numpy.random.RandomState``), so their arrays
and frames equal the JAX package's bit for bit.
:func:`make_realistic_coo_device` keeps the calibration of the JAX
device generator (Zipf margins, slowly decaying latent spectrum,
preference-correlated exposure by exact Gumbel-top-k sampling) but draws
from a ``torch.Generator`` on ``device``: the same distribution, a
different random stream.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.rng import generator_from_seed

# ML-1M rating histogram (share of 1..5 stars over the full dataset).
ML1M_RATING_HIST = (0.056, 0.108, 0.261, 0.349, 0.226)

# Benchmark-standard geometries (the MovieLens datasets the reference's
# published numbers use).
ML10M_GEOMETRY = dict(n_users=69_878, n_items=10_677, n_events=10_000_054)
ML1M_GEOMETRY = dict(n_users=6_040, n_items=3_706, n_events=1_000_209)
# Netflix-prize geometry: dense f32 at this shape is 31.8 GiB, past the
# memory budget, so models take the streaming tier (ops/sparse.py).
NETFLIX_GEOMETRY = dict(n_users=480_189, n_items=17_770,
                        n_events=100_480_507)


def make_synthetic_interactions(n_users: int = 1000, n_items: int = 500,
                                n_events: int = 20_000, rank: int = 8,
                                popularity_skew: float = 1.0,
                                rating_levels: int = 5,
                                include_time: bool = False,
                                seed: Optional[int] = 0):
    """Sample a deduplicated interaction log ``userid/movieid/rating`` as a
    pandas frame: Zipf-like item draws, ratings from a rank-``rank``
    latent score plus noise discretized onto ``1..rating_levels``."""
    import pandas as pd

    rs = np.random.RandomState(seed)
    weights = 1.0 / np.arange(1, n_items + 1) ** popularity_skew
    weights /= weights.sum()

    users = rs.randint(0, n_users, n_events * 2)
    items = rs.choice(n_items, n_events * 2, p=weights)
    pairs = np.unique(np.stack([users, items], axis=1), axis=0)
    if len(pairs) > n_events:
        keep = rs.choice(len(pairs), n_events, replace=False)
        pairs = pairs[np.sort(keep)]
    users, items = pairs[:, 0], pairs[:, 1]

    u_fac = rs.randn(n_users, rank) / np.sqrt(rank)
    i_fac = rs.randn(n_items, rank) / np.sqrt(rank)
    latent = (u_fac[users] * i_fac[items]).sum(axis=1)
    latent = latent + 0.25 * rs.randn(len(latent))
    qs = np.quantile(latent, np.linspace(0, 1, rating_levels + 1)[1:-1])
    ratings = np.digitize(latent, qs) + 1

    frame = {"userid": users, "movieid": items, "rating": ratings}
    if include_time:
        frame["timestamp"] = rs.randint(0, 10_000_000, len(users))
    return pd.DataFrame(frame)


def make_realistic_coo(n_users: int, n_items: int, n_events: int,
                       rank: int = 16, popularity_skew: float = 0.85,
                       activity_skew: float = 0.6,
                       spectrum_decay: float = 0.6, noise: float = 0.4,
                       affinity: float = 2.0, popularity_bias: float = 0.15,
                       rating_hist=ML1M_RATING_HIST,
                       min_events_per_user: int = 5,
                       seed: Optional[int] = 0):
    """Calibrated interaction log as row-sorted numpy COO arrays.

    Items follow a Zipf(``popularity_skew``) profile and users a
    Zipf(``activity_skew``) activity profile; latent factor k carries
    weight ``k**-spectrum_decay``; each user's items are drawn without
    replacement from ``softmax(log pop + affinity * u.v)`` (exact
    Gumbel-top-k sampling); ratings discretize the latent affinity plus
    noise onto 1..5 with global quantile edges matched to ``rating_hist``,
    with a mild bias toward popular items.  Pairs are unique.  Returns
    ``(rows, cols, vals)`` (int32, int32, float64); the event count is
    ``n_events`` up to per-user clipping.
    """
    max_per_user = int(0.5 * n_items)
    if n_events > n_users * max_per_user:
        raise ValueError("n_events too dense for without-replacement "
                         "sampling")
    rs = np.random.RandomState(seed)
    item_w = 1.0 / np.arange(1, n_items + 1) ** popularity_skew
    item_w /= item_w.sum()
    user_w = 1.0 / np.arange(1, n_users + 1) ** activity_skew
    user_w /= user_w.sum()

    # per-user event counts: largest-remainder split of n_events over the
    # activity profile, clipped to [min_events_per_user, n_items/2]
    n_per_user = _largest_remainder_counts(
        n_events, user_w, min_events_per_user, max_per_user, rs)

    # low-rank latent with sigma_k ~ k^-decay
    col_weights = np.arange(1, rank + 1, dtype=np.float64) ** -spectrum_decay
    u_fac = rs.randn(n_users, rank) * col_weights
    i_fac = rs.randn(n_items, rank)

    log_pop = np.log(item_w)
    rows_parts, cols_parts, score_parts = [], [], []
    chunk = max(1, min(n_users, int(4e7) // max(n_items, 1)))
    for start in range(0, n_users, chunk):
        stop = min(start + chunk, n_users)
        aff = u_fac[start:stop] @ i_fac.T
        aff /= max(aff.std(), 1e-12)
        logits = log_pop[None, :] + affinity * aff
        # Gumbel-top-k == sampling without replacement from softmax(logits)
        gumbel = -np.log(-np.log(
            rs.random_sample((stop - start, n_items)) + 1e-300) + 1e-300)
        keyed = logits + gumbel
        kmax = int(n_per_user[start:stop].max())
        top = np.argpartition(-keyed, kmax - 1, axis=1)[:, :kmax]
        # order the candidate block by key so row r takes its first n_r
        order = np.argsort(-np.take_along_axis(keyed, top, axis=1), axis=1)
        top = np.take_along_axis(top, order, axis=1)
        for r in range(stop - start):
            k = int(n_per_user[start + r])
            items_r = top[r, :k]
            rows_parts.append(np.full(k, start + r, dtype=np.int32))
            cols_parts.append(items_r.astype(np.int32))
            score_parts.append(aff[r, items_r])
    rows = np.concatenate(rows_parts)
    cols = np.concatenate(cols_parts)
    score = np.concatenate(score_parts)

    # ratings: latent affinity + noise + mild popularity->rating bias
    score = score + noise * rs.randn(len(score))
    pop_z = np.log1p(cols.astype(np.float64))
    pop_z = (pop_z - pop_z.mean()) / max(pop_z.std(), 1e-12)
    score -= popularity_bias * pop_z  # low col index == popular == higher
    edges = np.quantile(score, np.cumsum(rating_hist)[:-1])
    vals = (np.digitize(score, edges) + 1).astype(np.float64)
    return rows, cols, vals


def make_realistic_interactions(n_users: int = 2000, n_items: int = 1200,
                                n_events: int = 100_000,
                                seed: Optional[int] = 0, **kwargs):
    """pandas frame over :func:`make_realistic_coo` with non-contiguous
    external ids (so reindexing paths are exercised) and a seeded shuffle
    of the event order (so fold splits see interleaved users)."""
    import pandas as pd

    rows, cols, vals = make_realistic_coo(n_users, n_items, n_events,
                                          seed=seed, **kwargs)
    frame = pd.DataFrame({"userid": rows.astype(np.int64) * 7 + 10_001,
                          "movieid": cols.astype(np.int64) * 3 + 501,
                          "rating": vals.astype(np.int64)})
    rs = np.random.RandomState(None if seed is None else seed + 1)
    return (frame.sample(frac=1, random_state=rs)
            .reset_index(drop=True))


def _largest_remainder_counts(n_events: int, weights: np.ndarray,
                              lo: int, hi: int,
                              rs: np.random.RandomState) -> np.ndarray:
    """Integer per-user event counts from a weight profile, clipped to
    [lo, hi] and permuted so activity decouples from user id."""
    quota = n_events * weights
    counts = np.floor(quota).astype(np.int64)
    short = int(n_events - counts.sum())
    if short > 0:
        order = np.argsort(quota - counts)[::-1]
        counts[order[:short]] += 1
    counts = np.clip(counts, lo, hi)
    return rs.permutation(counts)


def _population_std(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.std(correction=0), min=1e-12)


def make_realistic_coo_device(n_users: int, n_items: int, n_events: int,
                              rank: int = 16, popularity_skew: float = 0.85,
                              activity_skew: float = 0.6,
                              spectrum_decay: float = 0.6,
                              noise: float = 0.4, affinity: float = 2.0,
                              popularity_bias: float = 0.15,
                              rating_hist=ML1M_RATING_HIST,
                              min_events_per_user: int = 5,
                              seed: int = 0, row_chunk: int = 8192,
                              device: Union[str, torch.device, None] = None):
    """Calibrated interaction log generated on ``device`` (default: the
    card; without one, name the CPU).

    Per-user event counts come from ``numpy.random.RandomState(seed)``
    exactly as in the JAX package; factors, Gumbel keys and rating noise
    come from a ``torch.Generator``.  Returns ``(rows, cols, vals)``
    tensors on ``device`` (int64, int64, f32), sorted by row, with unique
    (row, col) pairs; ratings are 1..5 on global quantile edges matched to
    ``rating_hist``.
    """
    max_per_user = int(0.5 * n_items)
    if n_events > n_users * max_per_user:
        raise ValueError("n_events too dense for without-replacement "
                         "sampling")
    device = resolve_device(device, "make_realistic_coo_device")
    rs = np.random.RandomState(seed)
    item_w = 1.0 / np.arange(1, n_items + 1) ** popularity_skew
    item_w /= item_w.sum()
    user_w = 1.0 / np.arange(1, n_users + 1) ** activity_skew
    user_w /= user_w.sum()
    n_per_user = _largest_remainder_counts(
        n_events, user_w, min_events_per_user, max_per_user, rs)

    gen = generator_from_seed(seed, device)
    f32 = torch.float32
    col_weights = torch.arange(1, rank + 1, dtype=torch.float64,
                               device=device) ** -spectrum_decay
    u_fac = (torch.randn((n_users, rank), generator=gen, dtype=f32,
                         device=device) * col_weights.to(f32))
    i_fac = torch.randn((n_items, rank), generator=gen, dtype=f32,
                        device=device)
    log_pop = torch.as_tensor(np.log(item_w), dtype=f32, device=device)
    counts_all = torch.as_tensor(n_per_user, device=device)

    rows_parts, cols_parts, score_parts = [], [], []
    for start in range(0, n_users, row_chunk):
        stop = min(start + row_chunk, n_users)
        aff = u_fac[start:stop] @ i_fac.T
        aff = aff / _population_std(aff)
        keyed = log_pop[None, :] + affinity * aff
        uniform = torch.rand(keyed.shape, generator=gen, dtype=f32,
                             device=device)
        keyed = keyed - torch.log(-torch.log(uniform.clamp(min=1e-30)))
        counts = counts_all[start:stop]
        kmax = int(n_per_user[start:stop].max())
        top = torch.topk(keyed, kmax, dim=1, sorted=True).indices
        take = torch.arange(kmax, device=device)[None, :] < counts[:, None]
        r_loc, pos = take.nonzero(as_tuple=True)
        cols = top[r_loc, pos]
        rows_parts.append(r_loc + start)
        cols_parts.append(cols)
        score_parts.append(aff[r_loc, cols])
    rows = torch.cat(rows_parts)
    cols = torch.cat(cols_parts)
    score = torch.cat(score_parts)

    # ratings: latent + noise + mild popularity->rating bias, discretized
    # on global quantile edges matched to the target rating histogram
    score = score + noise * torch.randn(score.shape, generator=gen,
                                        dtype=f32, device=device)
    pop_z = torch.log1p(cols.to(f32))
    pop_z = (pop_z - pop_z.mean()) / _population_std(pop_z)
    score = score - popularity_bias * pop_z
    edges = _quantiles(score, np.cumsum(rating_hist)[:-1])
    vals = (torch.searchsorted(edges, score, right=True) + 1).to(f32)
    return rows, cols, vals


def events_frame(rows, cols, vals):
    """``userid/movieid/rating`` pandas frame from COO arrays or tensors
    (the input of :class:`~polara_tpu_torch.data.RecommenderData`)."""
    import pandas as pd

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else \
            np.asarray(x)

    return pd.DataFrame({"userid": host(rows).astype(np.int64),
                         "movieid": host(cols).astype(np.int64),
                         "rating": host(vals).astype(np.int64)})


def _quantiles(x: torch.Tensor, qs) -> torch.Tensor:
    """Linear-interpolation quantiles (``numpy.quantile``'s default) by a
    full sort, free of ``torch.quantile``'s input-size limit."""
    ordered = torch.sort(x).values
    pos = torch.as_tensor(np.asarray(qs) * (x.numel() - 1),
                          dtype=torch.float64, device=x.device)
    lo = pos.floor().long()
    hi = torch.clamp(lo + 1, max=x.numel() - 1)
    frac = (pos - lo).to(x.dtype)
    return ordered[lo] + frac * (ordered[hi] - ordered[lo])
