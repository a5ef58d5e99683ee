"""The benchmark's inputs, made from ``--seed``.

A frozen copy of the port's calibrated generator
(``polara_tpu_torch.datasets.synthetic.make_realistic_coo_device``): Zipf
item and user margins, a rank-16 latent with a slowly decaying spectrum,
each user's items drawn without replacement from
``softmax(log pop + affinity * u.v)`` by Gumbel-top-k, and ratings 1..5 on
global quantile edges matched to ML-1M's histogram.  The copy lives here
so that a change to the program cannot change the benchmark's inputs.

The event counts come from ``numpy.random.RandomState``; factors, Gumbel
keys and rating noise from a ``torch.Generator`` on the device, so the same
seed gives the same events on the same kind of device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ML1M_RATING_HIST = (0.056, 0.108, 0.261, 0.349, 0.226)


class Events(NamedTuple):
    """The interaction log as host arrays, sorted by user."""
    rows: np.ndarray     # int64 user ids
    cols: np.ndarray     # int64 item ids
    vals: np.ndarray     # float64 ratings 1..5


def numpy_seed(seed: int, salt: int = 0) -> int:
    """A seed that ``numpy.random.RandomState`` takes (below 2**32)."""
    return (int(seed) + salt) % (2 ** 32)


def torch_seed(seed: int) -> int:
    """The 31-bit seed the port's ``generator_from_seed`` would keep."""
    return int(seed) & 0x7FFFFFFF


def _largest_remainder_counts(n_events, weights, lo, hi, rs):
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


def _quantiles(x: torch.Tensor, qs) -> torch.Tensor:
    ordered = torch.sort(x).values
    pos = torch.as_tensor(np.asarray(qs) * (x.numel() - 1),
                          dtype=torch.float64, device=x.device)
    lo = pos.floor().long()
    hi = torch.clamp(lo + 1, max=x.numel() - 1)
    frac = (pos - lo).to(x.dtype)
    return ordered[lo] + frac * (ordered[hi] - ordered[lo])


def make_events(n_users: int, n_items: int, n_events: int, seed: int,
                device, rank: int = 16, popularity_skew: float = 0.85,
                activity_skew: float = 0.6, spectrum_decay: float = 0.6,
                noise: float = 0.4, affinity: float = 2.0,
                popularity_bias: float = 0.15, rating_hist=ML1M_RATING_HIST,
                min_events_per_user: int = 5,
                row_chunk: int = 8192) -> Events:
    """The calibrated interaction log, drawn on ``device``, returned on the
    host (unique (user, item) pairs, sorted by user)."""
    max_per_user = int(0.5 * n_items)
    if n_events > n_users * max_per_user:
        raise ValueError("n_events too dense for without-replacement "
                         "sampling")
    rs = np.random.RandomState(numpy_seed(seed))
    item_w = 1.0 / np.arange(1, n_items + 1) ** popularity_skew
    item_w /= item_w.sum()
    user_w = 1.0 / np.arange(1, n_users + 1) ** activity_skew
    user_w /= user_w.sum()
    n_per_user = _largest_remainder_counts(
        n_events, user_w, min_events_per_user, max_per_user, rs)

    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
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
    score = score + noise * torch.randn(score.shape, generator=gen,
                                        dtype=f32, device=device)
    pop_z = torch.log1p(cols.to(f32))
    pop_z = (pop_z - pop_z.mean()) / _population_std(pop_z)
    score = score - popularity_bias * pop_z
    edges = _quantiles(score, np.cumsum(rating_hist)[:-1])
    vals = (torch.searchsorted(edges, score, right=True) + 1).to(f32)
    return Events(rows.cpu().numpy().astype(np.int64),
                  cols.cpu().numpy().astype(np.int64),
                  vals.cpu().numpy().astype(np.float64))


def holdout_mask(rows: np.ndarray, seed: int) -> np.ndarray:
    """One held-out event of every user (``rows`` sorted), drawn from the
    seed: a boolean mask over the events."""
    _, start, counts = np.unique(rows, return_index=True, return_counts=True)
    rs = np.random.RandomState(numpy_seed(seed, salt=7))
    pick = start + (rs.rand(len(start)) * counts).astype(np.int64)
    mask = np.zeros(len(rows), dtype=bool)
    mask[pick] = True
    return mask
