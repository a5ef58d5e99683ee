"""Exclusion sampling: random unseen items per user.

Counterpart of :mod:`polara_tpu.ops.samplers` (reference: the Numba
incremental Fisher-Yates samplers, ``polara/lib/sampler.py:11-132``), by
the same random-keys trick: draw one uniform key per catalog item, push
excluded items to -inf, take the top-k keys.  That is an exact uniform
sample without replacement, vectorized over a block of users as one masked
top-k on the device.

Keys come from an explicit ``torch.Generator`` on the device: a different
stream from ``jax.random``'s, so the two packages draw the same
distribution, not the same samples (a row whose unseen count equals the
sample size has one possible set, which both draw).

The (users x items) key block is drawn in row blocks of at most
:data:`KEY_BLOCK_BYTES`, so memory stays bounded at any catalog size.

``split_top_continuous`` (``sampler.py:135-165``) is a host-side
data-prep utility and stays numpy.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.ops.sparse import inner_product_at
from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.rng import generator_from_seed

# bytes of one block of rows: its (rows x items) f32 keys, or in
# sampled_scores its two (rows x n_samples x rank) gathers
KEY_BLOCK_BYTES = 1 << 28


def _sample_excluded(generator: torch.Generator, seen_rows: torch.Tensor,
                     seen_cols: torch.Tensor, seen_valid: torch.Tensor,
                     n_rows: int, n_cols: int, n_samples: int
                     ) -> torch.Tensor:
    """(n_rows, n_samples) int32 column ids, none of them a valid seen
    (row, col) pair, on the generator's device."""
    keys = torch.rand((n_rows, n_cols), generator=generator,
                      device=generator.device)
    keys[seen_rows[seen_valid].long(), seen_cols[seen_valid].long()] = \
        -torch.inf
    return torch.topk(keys, n_samples, dim=1).indices.to(torch.int32)


def _block_rows(n_rows: int, row_bytes: int,
                chunk_rows: Optional[int]) -> int:
    """Rows per block: ``chunk_rows`` if given, else as many rows of
    ``row_bytes`` as fit :data:`KEY_BLOCK_BYTES`; at most ``n_rows``."""
    if chunk_rows is None:
        chunk_rows = KEY_BLOCK_BYTES // max(row_bytes, 1)
    return max(1, min(int(chunk_rows), n_rows))


def sample_row_wise(seen_rows: np.ndarray, seen_cols: np.ndarray,
                    n_rows: int, n_cols: int, n_samples: int,
                    seed: Optional[int] = None,
                    chunk_rows: int = 8192,
                    device: Union[str, torch.device, None] = None
                    ) -> np.ndarray:
    """For every row, sample ``n_samples`` column indices not present in
    that row (uniform without replacement), drawn on ``device`` (default:
    the card; without one, name the CPU) in blocks of ``chunk_rows`` rows.
    Raises when a row has fewer than ``n_samples`` unseen columns.
    Returns an int32 numpy array (n_rows, n_samples)."""
    device = resolve_device(device, "sample_row_wise")
    seen_rows = np.asarray(seen_rows)
    seen_cols = np.asarray(seen_cols)
    counts = np.bincount(seen_rows, minlength=n_rows)
    if (n_cols - counts).min() < n_samples:
        raise ValueError("some rows have fewer unseen columns than "
                         "requested samples")
    gen = generator_from_seed(seed, device)
    order = np.argsort(seen_rows, kind="stable")
    rows_d = torch.as_tensor(seen_rows[order], device=device)
    cols_d = torch.as_tensor(seen_cols[order], device=device)
    step = _block_rows(n_rows, 4 * n_cols, chunk_rows)
    bounds = np.searchsorted(seen_rows[order],
                             np.arange(0, n_rows + step, step))
    out = np.empty((n_rows, n_samples), dtype=np.int32)
    for c, start in enumerate(range(0, n_rows, step)):
        stop = min(start + step, n_rows)
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        rows = rows_d[lo:hi] - start
        sampled = _sample_excluded(gen, rows, cols_d[lo:hi],
                                   torch.ones_like(rows, dtype=torch.bool),
                                   stop - start, n_cols, n_samples)
        out[start:stop] = sampled.cpu().numpy()
    return out


def sampled_scores(user_factors: torch.Tensor, item_factors: torch.Tensor,
                   seen_rows: torch.Tensor, seen_cols: torch.Tensor,
                   seen_valid: torch.Tensor, generator: torch.Generator,
                   n_samples: int, chunk_rows: Optional[int] = None,
                   return_items: bool = False):
    """Sample ``n_samples`` unseen items per user and score them: the
    fused analogue of ``mf_random_item_scoring``
    (``polara/lib/sampler.py:73-93``).  Returns the (n_users, n_samples)
    scores, with ``return_items`` also the int32 item ids.

    Users run in blocks of ``chunk_rows`` (default: the f32 key block and
    the two (rows x n_samples x rank) gathers each within
    :data:`KEY_BLOCK_BYTES`), each drawing its keys from ``generator`` in
    turn, so one seed gives the same samples for the same shapes.  The
    seen pairs may come in any order."""
    n_users, rank = user_factors.shape
    n_items = item_factors.shape[0]
    device = user_factors.device
    row_bytes = max(4 * n_items,
                    2 * n_samples * rank * user_factors.element_size())
    step = _block_rows(n_users, row_bytes, chunk_rows)
    seen_rows = torch.as_tensor(seen_rows, device=device).long()
    order = torch.argsort(seen_rows, stable=True)
    seen_rows = seen_rows[order]
    seen_cols = torch.as_tensor(seen_cols, device=device).long()[order]
    seen_valid = torch.as_tensor(seen_valid, device=device).bool()[order]
    bounds = torch.searchsorted(
        seen_rows, torch.arange(0, n_users + step, step, device=device)
    ).tolist()
    scores, items = [], []
    for c, start in enumerate(range(0, n_users, step)):
        stop = min(start + step, n_users)
        lo, hi = bounds[c], bounds[c + 1]
        sampled = _sample_excluded(generator, seen_rows[lo:hi] - start,
                                   seen_cols[lo:hi], seen_valid[lo:hi],
                                   stop - start, n_items, n_samples)
        users = torch.arange(start, stop, device=device)[:, None]
        scores.append(inner_product_at(user_factors, item_factors, users,
                                       sampled, block_rows=stop - start))
        items.append(sampled)
    scores = scores[0] if len(scores) == 1 else torch.cat(scores, 0)
    if return_items:
        return scores, items[0] if len(items) == 1 else torch.cat(items, 0)
    return scores


def split_top_continuous(tasks: np.ndarray, priorities: np.ndarray
                         ) -> Tuple[List[int], List[int], List[int]]:
    """Pick, per task, its highest-priority instance, but flag instances
    that interrupt a contiguous top block (reference
    ``sampler.py:135-165``): used to avoid "recommendations from the
    future" in temporal splits.

    Walk instances in descending priority; the first occurrence of each
    task joins the top sequence, later occurrences above the global cutoff
    displace the earlier pick into the non-sequential set.  From 10,000
    tasks on, the native C++ library (:mod:`polara_tpu_torch.native`)
    takes the walk, as in the JAX package.
    """
    tasks = np.asarray(tasks)
    if len(tasks) >= 10_000:
        from polara_tpu_torch import native
        if native.native_available():
            return native.split_top_continuous(
                tasks, np.asarray(priorities, dtype=np.float64))
    order = np.argsort(-np.asarray(priorities), kind="stable")
    top_of: dict = {}
    nonseq_idx: List[int] = []
    remaining = set(tasks.tolist())
    consumed = 0
    for idx in order:
        consumed += 1
        task = tasks[idx]
        if task in top_of:
            nonseq_idx.append(top_of[task])
        else:
            remaining.discard(task)
        top_of[task] = int(idx)
        if not remaining:
            break
    topseq_idx = list(top_of.values())
    lowseq_idx = [int(i) for i in order[consumed:]]
    return topseq_idx, lowseq_idx, nonseq_idx
