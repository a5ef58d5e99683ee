"""Data-model mixins for alternative evaluation protocols.

Host copy of :mod:`polara_tpu.data.mixins`.  ``SampledEvaluationMixin``
reproduces the reference's sampled-candidate protocol
(``polara/recommender/data.py:938-994``): each test user is scored on
their holdout items plus a fixed-size list of unseen items, instead of the
full catalog (the EigenRec/NCF-style evaluation;
:class:`polara_tpu_torch.models.sampled.SampledEvaluationSVDMixin` scores
it).  ``LongTailMixin`` restricts the holdout to long-tail items on both
holdout routes of the data model (pandas and native).
"""
from __future__ import annotations

import numpy as np
import pandas as pd


class SampledEvaluationMixin:
    """Adds per-user unseen-interaction lists for sampled evaluation."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.unseen_interactions = None
        self.unseen_items_num = None
        self._holdout_item_prefix = "x"

    def adapt_holdout(self) -> None:
        """Rebase holdout item ids to a per-user 0..h-1 column.

        Holdout items occupy the first columns of the sampled score matrix,
        so their "item index" is just their position within the user's
        holdout.
        """
        holdout = self.test.holdout
        userid = self.fields.userid
        itemid = self.fields.itemid
        position = holdout.groupby(userid, sort=False)[itemid] \
                          .transform("cumcount")
        holdout.loc[:, f"{self._holdout_item_prefix}_{itemid}"] = position

    def set_unseen_interactions(self, interactions: pd.Series,
                                reindex: bool = True,
                                warm_start: bool = False) -> None:
        n_unseen = len(interactions.iloc[0])
        if not interactions.apply(len).eq(n_unseen).all():
            raise ValueError("Number of unseen items per user must be equal")
        if reindex:
            if warm_start:
                raise NotImplementedError(
                    "Sampled evaluation with warm start is not supported yet")
            userid = self.fields.userid
            itemid = self.fields.itemid
            user_map = self.get_entity_index(userid).set_index("old").new
            interactions = interactions.loc[user_map.index]
            new_users = pd.Index(interactions.index.map(user_map),
                                 name=userid)
            if new_users.isnull().any():
                raise IndexError("Input is inconsistent with existing data.")
            item_map = self.get_entity_index(itemid).set_index("old").new
            interactions = pd.Series(
                index=new_users,
                data=[item_map.loc[items].values for items in
                      interactions.values],
                name=itemid)
        self.unseen_interactions = interactions
        self.unseen_items_num = n_unseen
        self.adapt_holdout()


class LongTailMixin:
    """Restrict the holdout to long-tail items.

    The reference declares this mixin but raises at construction
    (``data.py:997-999``); here it works: when ``long_tail_holdout`` is
    set, holdout sampling only considers items outside the short head —
    either an explicit ``short_head_items`` list, the most-popular items
    accumulating ``head_feedback_frac`` of feedback, or the top
    ``head_items_frac`` fraction of the catalog.  Short-head interactions
    stay in the training/testset side of the split.

    Deviation from the reference's (dead) sketch: popularity is computed
    over the full interaction log at split time (the training set does
    not exist yet while the holdout is being sampled).
    """

    def __init__(self, *args, long_tail_holdout: bool = False,
                 short_head_items=None, head_feedback_frac: float = 0.33,
                 head_items_frac=None, **kwargs):
        self.long_tail_holdout = long_tail_holdout
        self.short_head_items = short_head_items
        self.head_feedback_frac = head_feedback_frac
        self.head_items_frac = head_items_frac
        super().__init__(*args, **kwargs)

    def _long_tail_raw_items(self):
        """Long-tail item ids in the raw (external) id space."""
        itemid = self.fields.itemid
        if self.short_head_items is not None:
            all_items = pd.unique(self._data[itemid])
            head = set(self.short_head_items)
            return np.array([i for i in all_items if i not in head])

        popularity = self._data[itemid].value_counts(normalize=True)
        tail_sel = None
        if self.head_items_frac:
            items_frac = (np.arange(1, len(popularity) + 1)
                          / len(popularity))
            tail_sel = items_frac > self.head_items_frac
        elif self.head_feedback_frac:
            tail_sel = popularity.cumsum().values > self.head_feedback_frac
        if tail_sel is None:
            return None
        return popularity.index[tail_sel].values

    def _sample_holdout(self, test_split, group_id=None):
        if self.long_tail_holdout:
            tail = self._long_tail_raw_items()
            if tail is not None:
                itemid = self.fields.itemid
                is_tail = self._data[itemid].isin(tail).values
                if isinstance(test_split, slice):
                    test_split = is_tail
                else:
                    test_split = np.asarray(test_split) & is_tail
        return super()._sample_holdout(test_split, group_id=group_id)
