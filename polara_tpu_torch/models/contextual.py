"""Contextual post-filtering model mixin.

Counterpart of :mod:`polara_tpu.models.contextual` (reference
``polara/recommender/contextual/models.py:4-32``).  The boost is part of
the score step: a gather of each user's upvoted items and a scatter-max
on the chunk's score block, before the seen-item mask, so post-filtering
costs one gather and one scatter on the device.  The boost rewrites the
dense scores, which the fused kernel cannot express: the mixin keeps its
models on the unfused route.
"""
from __future__ import annotations

import torch

from polara_tpu_torch.ops.scoring import TestChunk


class ItemPostFilteringMixin:
    """Boost the scores of items matching each test user's holdout context
    above the chunk's maximum, keeping their relative order (reference
    formula ``upscored = scores.max() + context_scores + 1``)."""

    # the boost rewrites dense scores: no proj_chunk, so no fused route
    proj_chunk = None

    def score_params(self) -> dict:
        params = dict(super().score_params())
        items, valid = self.data.upvote_arrays()
        params["upvote_items"] = torch.as_tensor(items,
                                                 device=self.device).long()
        params["upvote_valid"] = torch.as_tensor(valid, device=self.device)
        return params

    @classmethod
    def score_chunk(cls, params: dict, chunk: TestChunk) -> torch.Tensor:
        """The base model's chunk scores, then every valid upvoted item
        raised to ``max + score + 1`` (the maximum over the whole block,
        padded rows included, in the scores' dtype)."""
        scores = super(ItemPostFilteringMixin, cls).score_chunk(params,
                                                               chunk)
        upvote = params["upvote_items"][chunk.users]            # (cu, m)
        valid = (params["upvote_valid"][chunk.users]
                 & chunk.user_valid[:, None])
        rows = torch.arange(upvote.shape[0], device=scores.device
                            )[:, None].expand_as(upvote)
        current = scores[rows, upvote]
        boosted = scores.max() + current.to(scores.dtype) + 1
        update = torch.where(valid, boosted,
                             torch.tensor(-torch.inf, dtype=scores.dtype,
                                          device=scores.device))
        flat = torch.where(valid, upvote, 0) + rows * scores.shape[1]
        return scores.reshape(-1).scatter_reduce(
            0, flat.reshape(-1), update.reshape(-1), "amax"
        ).view(scores.shape)
