"""Synthetic interaction generators (counterpart of
:mod:`polara_tpu.datasets.synthetic`).

:func:`make_synthetic_interactions` is the JAX package's numpy generator,
draw for draw.  :func:`make_realistic_coo_device` keeps the calibration of
the JAX device generator (Zipf margins, slowly decaying latent spectrum,
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
