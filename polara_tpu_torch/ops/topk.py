"""Seen-item masking and top-k selection: the unfused scoring path.

Counterpart of :mod:`polara_tpu.ops.topk` (the reference's
``downvote_seen_items`` + ``get_topk_elements``,
``polara/recommender/models.py:494-564``).  The fused kernel in
:mod:`polara_tpu_torch.ops.fused_topk` replaces this pair on CUDA for
factor models; this path keeps the reference's shift-formula tail order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

PAD_CONST = -1  # emitted for positions beyond the catalog (parity with
                # reference ``_pad_const``, models.py:73)


def downvote_items(scores: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, valid: torch.Tensor,
                   block_min: Optional[torch.Tensor] = None,
                   seen_max: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Push the listed (row, col) scores below the block minimum.

    The reference's shift formula (``models.py:510-519``):
    ``lowered = min(scores) - (max(seen) - seen) - 1`` with the minimum and
    the maximum taken over the WHOLE block, not per row — seen items keep
    their relative order but always rank after every unseen item, which
    matters when k exceeds the number of unseen items.

    ``valid`` masks padding entries: they scatter +inf under ``amin``, a
    no-op even when their fill collides with a real entry.  Returns a new
    tensor; ``scores`` is left unchanged.

    ``block_min`` and ``seen_max`` override the two block-wide values when
    ``scores`` is one row shard of a larger block
    (:func:`mask_and_topk_sharded`).
    """
    if rows.numel() == 0:
        return scores
    rows = rows.long()
    cols = cols.long()
    seen_vals = scores[rows, cols]
    neg_inf = torch.tensor(-torch.inf, dtype=scores.dtype,
                           device=scores.device)
    if seen_max is None:
        seen_max = torch.where(valid, seen_vals, neg_inf).max()
    if block_min is None:
        block_min = scores.min()
    lowered = block_min - (seen_max - seen_vals) - 1
    update = torch.where(valid, lowered, -neg_inf)
    flat = scores.clone().view(-1)
    flat.scatter_reduce_(0, rows * scores.shape[1] + cols, update, "amin")
    return flat.view(scores.shape)


def top_k_indices(scores: torch.Tensor, k: int,
                  n_valid_cols: Optional[int] = None) -> torch.Tensor:
    """Indices of the k largest entries per row, ties to the lowest index.

    ``torch.topk`` leaves the order of ties unspecified, so this takes a
    stable descending sort and slices it.  ``n_valid_cols`` masks out
    padded catalog columns; when k exceeds the catalog size, trailing
    positions are PAD_CONST.
    """
    n_cols = scores.shape[-1]
    if n_valid_cols is not None and n_valid_cols < n_cols:
        col_ids = torch.arange(n_cols, device=scores.device)
        scores = scores.masked_fill(col_ids >= n_valid_cols, -torch.inf)
    limit = n_valid_cols if n_valid_cols is not None else n_cols
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :min(k, limit)].to(torch.int32)
    if k <= limit:
        return idx
    pad = torch.full(scores.shape[:-1] + (k - limit,), PAD_CONST,
                     dtype=torch.int32, device=scores.device)
    return torch.cat([idx, pad], dim=-1)


def mask_and_topk(scores: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, valid: torch.Tensor, k: int,
                  filter_seen: bool = True,
                  n_valid_cols: Optional[int] = None) -> torch.Tensor:
    if filter_seen:
        scores = downvote_items(scores, rows, cols, valid)
    return top_k_indices(scores, k, n_valid_cols)


def mask_and_topk_sharded(parts: Sequence[torch.Tensor], rows: torch.Tensor,
                          cols: torch.Tensor, valid: torch.Tensor, k: int,
                          filter_seen: bool = True,
                          n_valid_cols: Optional[int] = None
                          ) -> List[torch.Tensor]:
    """:func:`mask_and_topk` of a score block split into consecutive row
    shards, each ranked on its own device: one (rows, k) int32 tensor per
    part, equal to the matching rows of the unsharded result.

    ``rows`` index the whole block.  The shift formula's block minimum
    and seen maximum are reduced over the shards first (two scalars per
    shard cross to the first part's device and back), so every shard
    lowers its seen items exactly as the unsharded block would."""
    if not filter_seen:
        return [top_k_indices(part, k, n_valid_cols) for part in parts]
    home = parts[0].device
    rows = rows.long()
    local, mins, maxes = [], [], []
    lo = 0
    for part in parts:
        hi = lo + part.shape[0]
        sel = (rows >= lo) & (rows < hi)
        r, c, v = ((rows[sel] - lo).to(part.device),
                   cols[sel].long().to(part.device),
                   valid[sel].to(part.device))
        local.append((r, c, v))
        mins.append(part.min().to(home))
        seen = torch.where(v, part[r, c], -torch.inf)
        maxes.append(seen.max().to(home) if seen.numel()
                     else torch.tensor(-torch.inf, dtype=part.dtype,
                                       device=home))
        lo = hi
    block_min, seen_max = torch.stack(mins).min(), torch.stack(maxes).max()
    return [top_k_indices(downvote_items(part, r, c, v,
                                         block_min.to(part.device),
                                         seen_max.to(part.device)),
                          k, n_valid_cols)
            for part, (r, c, v) in zip(parts, local)]
