"""Contextual post-filtering data model.

Host copy of :mod:`polara_tpu.data.contextual` (reference
``polara/recommender/contextual/data.py:4-58``).  The interaction frame
carries extra context columns (e.g. genre); after each split the holdout
context of every test user is mapped to the internal item ids matching
that context, so models can boost those items before top-k
(:class:`polara_tpu_torch.models.contextual.ItemPostFilteringMixin`).

Device export: :meth:`upvote_arrays` packs the per-test-user upvote lists
into a padded ``(n_test_users, width)`` int array + validity mask, filled
from the same Python sets as the JAX package's, so the arrays are equal.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from polara_tpu_torch.data.dataset import RecommenderData


class ItemPostFilteringData(RecommenderData):
    def __init__(self, *args, item_context_mapping: Dict[str, pd.DataFrame],
                 **kwargs):
        super().__init__(*args, **kwargs)
        userid = self.fields.userid
        itemid = self.fields.itemid
        self.item_context_mapping = dict(**item_context_mapping)
        self.context_data = {context: dict.fromkeys([userid, itemid])
                             for context in item_context_mapping}

    def map_context_data(self, context: Optional[str]) -> None:
        if context is None:
            return
        userid = self.fields.userid
        itemid = self.fields.itemid

        context_mapping = self.item_context_mapping[context]
        item_index = getattr(self.index.itemid, "training",
                             self.index.itemid)
        index_mapping = item_index.set_index("old")["new"]
        known = context_mapping[context_mapping[itemid]
                                .isin(index_mapping.index)]
        item_data = (known.assign(**{itemid: known[itemid]
                                     .map(index_mapping)})
                     .groupby(context)[itemid].apply(list))

        holdout = self.test.holdout
        if holdout is None:
            print(f"Unable to map {context}: holdout data is not recognized")
            return
        if context not in holdout.columns:
            print(f"Unable to map {context}: not present in holdout")
            return
        user_data = holdout.set_index(userid)[context]
        item_data = item_data.reindex(user_data.drop_duplicates().values)
        item_data = item_data.apply(
            lambda x: x if isinstance(x, list) else [])

        self.context_data[context][userid] = user_data
        self.context_data[context][itemid] = item_data

    def update_contextual_data(self) -> None:
        holdout = self.test.holdout
        if holdout is not None:
            # post-filtering assumes a single holdout item per user
            assert holdout.shape[0] == holdout[self.fields.userid].nunique()
            for context in self.item_context_mapping:
                self.map_context_data(context)

    def prepare(self, *args, **kwargs) -> None:
        super().prepare(*args, **kwargs)
        self.update_contextual_data()

    def set_test_data(self, *args, **kwargs) -> None:
        super().set_test_data(*args, **kwargs)
        self.update_contextual_data()

    def upvote_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Padded per-test-user upvote item lists, rows ordered like the
        recommendation matrix (holdout users, sorted)."""
        userid = self.fields.userid
        holdout = self.test.holdout
        test_users = holdout[userid].drop_duplicates().values

        per_user = [set() for _ in test_users]
        for context, data in self.context_data.items():
            user_ctx = data.get(userid)
            item_ctx = data.get(self.fields.itemid)
            if user_ctx is None or item_ctx is None:
                continue
            for row, user in enumerate(test_users):
                ctx_value = user_ctx.loc[user]
                if isinstance(ctx_value, pd.Series):  # defensive: dup users
                    ctx_value = ctx_value.iloc[0]
                per_user[row].update(item_ctx.loc[ctx_value])

        width = max(1, max((len(s) for s in per_user), default=1))
        items = np.zeros((len(test_users), width), dtype=np.int32)
        valid = np.zeros((len(test_users), width), dtype=bool)
        for row, s in enumerate(per_user):
            vals = np.fromiter(s, dtype=np.int32, count=len(s))
            items[row, :len(vals)] = vals
            valid[row, :len(vals)] = True
        return items, valid
