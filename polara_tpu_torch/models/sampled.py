"""Sampled-candidate evaluation for factor models.

Counterpart of :mod:`polara_tpu.models.sampled` (reference
``RandomSampleEvaluationSVDMixin``, ``polara/recommender/models.py:
1095-1183``): the EigenRec-style protocol, where each test user is ranked
over their holdout items plus a fixed number of unseen items instead of
the whole catalog.  Holdout items occupy score columns 0..h-1 (the data
mixin's rebased ``x_<itemid>`` column), so the standard HR/MRR metrics
apply unchanged.

The device work runs on the model's device: the profile fold-in as a
sorted segment sum (no float atomics: two calls give the same bits on
the card), the candidate scores through
:func:`~polara_tpu_torch.ops.sparse.inner_product_at` or, sampled on the
fly, :func:`~polara_tpu_torch.ops.samplers.sampled_scores`, both blocked
over users, and the ranking through
:func:`~polara_tpu_torch.ops.topk.top_k_indices`' stable sort, so a
holdout item tied with a sampled one ranks first, as under ``lax.top_k``.
The fused kernel does not apply: candidates differ per user.  This module
loads pandas on first use only.
"""
from __future__ import annotations

import numpy as np
import torch

from polara_tpu_torch.ops.samplers import sampled_scores
from polara_tpu_torch.ops.sparse import inner_product_at, sorted_rows_matmul
from polara_tpu_torch.ops.topk import top_k_indices
from polara_tpu_torch.runtime.rng import generator_from_seed


def _holdout_rows(holdout, userid: str) -> np.ndarray:
    """Test-row position of each holdout event (users in holdout order)."""
    import pandas as pd
    return pd.factorize(holdout[userid], sort=False)[0]


class SampledEvaluationSVDMixin:
    """Mix into SVD-family models whose data model carries
    ``unseen_interactions`` (see
    :class:`polara_tpu_torch.data.mixins.SampledEvaluationMixin`)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        prefix = self.data._holdout_item_prefix
        self._prediction_target = f"{prefix}_{self.data.fields.itemid}"

    def _test_user_factors(self):
        """Fold test profiles into factor space, ``P = R_test · V``, as a
        sorted segment sum over the user-sorted test events."""
        itemid = self.data.fields.itemid
        item_factors = self.factors[itemid]
        (user_rows, item_idx, feedback), test_shape, _ = \
            self._get_test_data()
        device = item_factors.device
        vals = torch.as_tensor(np.asarray(feedback, dtype=np.float64),
                               device=device).to(item_factors.dtype)
        user_factors = sorted_rows_matmul(
            torch.as_tensor(user_rows, device=device).long(),
            torch.as_tensor(item_idx, device=device).long(), vals,
            item_factors, test_shape[0])
        return user_factors, item_factors, (user_rows, item_idx)

    def compute_holdout_scores(self, user_factors, item_factors):
        holdout = self.data.test.holdout
        userid = self.data.fields.userid
        itemid = self.data.fields.itemid
        holdout_size = int(self.data.holdout_size)
        if holdout_size < 1:
            raise ValueError("sampled evaluation requires a fixed integer "
                             "holdout size")
        useridx = _holdout_rows(holdout, userid).reshape(-1, holdout_size)
        itemidx = holdout[itemid].values.reshape(-1, holdout_size)
        return inner_product_at(
            user_factors, item_factors, torch.as_tensor(useridx),
            torch.as_tensor(itemidx.astype(np.int64)))

    def compute_random_item_scores(self, user_factors, item_factors):
        """Score the pre-registered per-user unseen lists."""
        holdout = self.data.test.holdout
        userid = self.data.fields.userid
        test_users = holdout[userid].drop_duplicates().values
        test_items = self.data.unseen_interactions.loc[test_users].values
        n_users = len(test_users)
        n_items = self.data.unseen_items_num
        itemidx = np.concatenate(test_items).reshape(n_users, n_items)
        return inner_product_at(
            user_factors, item_factors, torch.arange(n_users)[:, None],
            torch.as_tensor(itemidx.astype(np.int64)))

    def compute_random_item_scores_gen(self, user_factors, item_factors,
                                       seen_pairs, n_unseen: int):
        """Sample unseen items on the fly (excluding the profile and the
        holdout) and score them: the fused analogue of
        ``compute_random_item_scores_gen`` (``models.py:1137-1156``), with
        the draws from a generator seeded by the data's seed."""
        holdout = self.data.test.holdout
        userid = self.data.fields.userid
        itemid = self.data.fields.itemid
        user_rows, item_idx = seen_pairs
        hold_users = _holdout_rows(holdout, userid)
        all_rows = np.concatenate([user_rows, hold_users]).astype(np.int64)
        all_cols = np.concatenate([item_idx, holdout[itemid].values]
                                  ).astype(np.int64)
        device = user_factors.device
        return sampled_scores(
            user_factors, item_factors, torch.as_tensor(all_rows),
            torch.as_tensor(all_cols),
            torch.ones(len(all_rows), dtype=torch.bool),
            generator_from_seed(self.data.seed, device), n_unseen)

    def get_recommendations(self):
        itemid = self.data.fields.itemid
        if self._prediction_target == itemid:
            return super().get_recommendations()

        if self._prediction_target not in self.data.test.holdout:
            self.data.adapt_holdout()
        user_factors, item_factors, seen_pairs = self._test_user_factors()
        holdout_scores = self.compute_holdout_scores(user_factors,
                                                     item_factors)
        if self.data.unseen_interactions is None:
            n_unseen = self.data.unseen_items_num
            if n_unseen is None:
                raise ValueError(
                    "Number of items to sample is unspecified.")
            unseen_scores = self.compute_random_item_scores_gen(
                user_factors, item_factors, seen_pairs, n_unseen)
        else:
            unseen_scores = self.compute_random_item_scores(
                user_factors, item_factors)
        scores = torch.cat((holdout_scores, unseen_scores), dim=1)
        recs = top_k_indices(scores, self.topk)
        return recs if self._scoring_device_output else recs.cpu().numpy()
