"""Item cold-start data model.

Host-side copy of :mod:`polara_tpu.data.coldstart` (reference
``polara/recommender/coldstart/data.py:10-259``).  The scenario flips the
split axis: *items* (not user sessions) are fold-split into a cold set;
the holdout is every interaction of the cold items with the item column
renamed to ``<itemid>_cold``; models then recommend *users* for each cold
item, optionally restricted to a sampled subset of "representative"
users.

Deviation from the reference, kept from the JAX package: after
post-processing filters (feature overlap, representative users) the
cold-item index is **recoded to a contiguous 0..m-1 range** and the
holdout follows — the reference leaves gaps in the code space, which
silently misaligns rank rows during evaluation when any cold item is
filtered.  The cold x seen similarity slices
(:class:`ColdSimilarityMixin`) are taken on the relations matrix's device.
"""
from collections import defaultdict, namedtuple
from typing import Optional

import numpy as np
import pandas as pd

from polara_tpu_torch.data.dataset import (RecommenderData,
                                           build_entity_index)
from polara_tpu_torch.data.hybrid import (IdentityDiagonalMixin,
                                          SideRelationsMixin)
from polara_tpu_torch.data.scenario import UpdateRule
from polara_tpu_torch.preprocessing.features import build_indicator_matrix

ItemIndex = namedtuple("ItemIndex", ["training", "cold_start"])


class ItemColdStartData(RecommenderData):
    def __init__(self, *args, item_features: Optional[pd.DataFrame] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.item_features = item_features
        self._test_ratio = 0.2
        self._warm_start = False
        self._holdout_size = -1  # all interactions of cold items

        # unique items are permuted once, then fold-split deterministically
        itemid = self.fields.itemid
        permute = np.random.RandomState(self.seed).permutation
        self._unique_items = permute(self._data[itemid].unique())

        self._test_sample = None  # float frac / int n of representative users
        self._repr_users = None

    # --- fixed-config guards -------------------------------------------------

    @property
    def holdout_size(self):
        return -1

    @holdout_size.setter
    def holdout_size(self, new_value):
        if new_value == 0:  # allows prepare_training_only / set_test_data
            self._holdout_size = 0
        else:
            raise NotImplementedError("Setting holdout size is not "
                                      "supported in item cold start.")

    @property
    def warm_start(self):
        return False

    @warm_start.setter
    def warm_start(self, new_value):
        if new_value:
            raise ValueError("warm start is undefined for item cold start")
        self._warm_start = False

    @property
    def representative_users(self) -> Optional[pd.DataFrame]:
        """Sampled subset of training users used as the candidate pool and
        as the evaluation filter (reference ``coldstart/data.py:37-46``)."""
        if self._repr_users is None:
            sample = self.test_sample
            if sample:
                params = {("frac" if sample < 1 else "n"): sample,
                          "random_state": np.random.RandomState(self.seed)}
                all_users = self.index.userid.training
                self._repr_users = (all_users.sample(**params)
                                    .sort_values("new"))
        return self._repr_users

    # --- split machinery overrides ------------------------------------------

    def _plan_update(self, changed: frozenset):
        new_state, rule = super()._plan_update(changed)
        # test_sample changes are invisible to the generic state machine
        # (scenario 3 has no testset); they must re-trigger post-processing
        if "test_sample" in changed and not rule.any:
            rule = UpdateRule(test_update=True)
        return new_state, rule

    def prepare(self) -> None:
        super().prepare()
        if self._last_update_rule is not None and self._last_update_rule.any:
            self._post_process_cold_items()

    def _split_test_index(self):
        itemid = self.fields.itemid
        item_idx = np.arange(len(self._unique_items))
        fold_mask = self._fold_mask(item_idx, len(item_idx),
                                    self._test_fold, self._test_ratio)
        cold_items = self._unique_items[fold_mask]
        return self._data[itemid].isin(cold_items).values

    def _sample_holdout(self, test_split, group_id=None) -> pd.DataFrame:
        itemid = self.fields.itemid
        if self._holdout_size > 0:  # per-cold-item top users
            holdout = super()._sample_holdout(test_split, group_id=itemid)
        else:  # all interactions with cold items
            fields = [f for f in self.fields if f is not None]
            holdout = self._data.loc[test_split, fields]
        return holdout.rename(columns={itemid: self.cold_itemid})

    @property
    def cold_itemid(self) -> str:
        return f"{self.fields.itemid}_cold"

    def _drop_unseen_test_items(self, *args, **kwargs):
        pass  # the only unseen test items are the cold items themselves

    def _filter_short_sessions(self, group_id=None):
        super()._filter_short_sessions(group_id=self.cold_itemid)

    def _assign_test_items_index(self):
        if self.build_index and self._test.holdout is not None:
            self._reindex_cold_items()

    def _reindex_cold_items(self):
        holdout = self._test.holdout
        cold_item_index = build_entity_index(holdout, self.cold_itemid,
                                             sort=False)
        item_index = getattr(self.index.itemid, "training",
                             self.index.itemid)
        self.index = self.index._replace(
            itemid=ItemIndex(item_index, cold_item_index))

    def _sort_test_data(self):
        pass  # sorting by cold items happens in post-processing

    def get_test_shape(self, tensor_mode: bool = False):
        n_cold = self.index.itemid.cold_start.shape[0]
        if self.representative_users is not None:
            n_users = self.representative_users.shape[0]
        else:
            n_users = self.index.userid.training.shape[0]
        return (n_cold, n_users)

    # --- cold-item post-processing ------------------------------------------

    def _post_process_cold_items(self):
        self._repr_users = None  # resample against the new split
        if self._test.holdout is not None:
            self._verify_cold_items_representatives()
            self._verify_cold_items_features()
            self._cleanup_cold_items()
            self._sort_by_cold_items()

    def _verify_cold_items_representatives(self):
        """Flag cold items with no interactions among representative users
        (reference ``coldstart/data.py:143-159``)."""
        repr_users = self.representative_users
        if repr_users is None:
            return
        userid = self.fields.userid
        holdout = self._test.holdout
        is_repr_user = holdout[userid].isin(repr_users["new"])
        repr_items = holdout.loc[is_repr_user, self.cold_itemid].unique()
        cold_index = self.index.itemid.cold_start
        is_repr = cold_index["new"].isin(repr_items)
        if not is_repr.all():
            cold_index["is_repr"] = is_repr

    def _verify_cold_items_features(self):
        """Flag cold items with no feature overlap with any seen item
        (reference ``coldstart/data.py:162-184``)."""
        if self.item_features is None:
            return
        if self.item_features.shape[1] > 1:
            melted = self.item_features.agg(
                lambda x: [f for row in x for f in row], axis=1)
        else:
            melted = self.item_features.iloc[:, 0]

        feature_labels = defaultdict(lambda: len(feature_labels))
        labels = melted.apply(lambda x: [feature_labels[i] for i in x])

        item_index = self.index.itemid
        cold_idx = item_index.cold_start["old"]
        seen_idx = item_index.training["old"]

        n_labels = len(feature_labels)
        cold_matrix = build_indicator_matrix(labels.reindex(cold_idx)
                                             .apply(lambda x: x if
                                                    isinstance(x, list)
                                                    else []), n_labels)
        seen_matrix = build_indicator_matrix(labels.reindex(seen_idx)
                                             .apply(lambda x: x if
                                                    isinstance(x, list)
                                                    else []), n_labels)
        is_valid = cold_matrix.dot(seen_matrix.T).getnnz(axis=1) > 0
        if not is_valid.all():
            item_index.cold_start["is_valid"] = is_valid

    def _cleanup_cold_items(self):
        """Drop flagged cold items/holdout rows, then recode cold item ids
        to a contiguous range (deviation documented in the module
        docstring)."""
        holdout = self._test.holdout
        cold_index = self.index.itemid.cold_start

        keep = np.ones(len(cold_index), dtype=bool)
        if "is_valid" in cold_index:
            keep &= cold_index["is_valid"].values
        if "is_repr" in cold_index:
            keep &= cold_index["is_repr"].values
        cold_index = cold_index.loc[keep, ["old", "new"]]

        keep_events = holdout[self.cold_itemid].isin(cold_index["new"])
        if self.representative_users is not None:
            keep_events &= holdout[self.fields.userid].isin(
                self.representative_users["new"])
        holdout.drop(holdout.index[~keep_events.values], inplace=True)

        # drop cold items that lost all holdout events, then recode
        cold_index = cold_index[cold_index["new"]
                                .isin(holdout[self.cold_itemid])]
        recode = pd.Series(np.arange(len(cold_index)),
                           index=cold_index["new"].values)
        # whole-column assignment: .loc refuses int64 codes when the
        # source id column is narrower (pandas>=3)
        holdout[self.cold_itemid] = holdout[self.cold_itemid].map(recode)
        cold_index = cold_index.assign(new=np.arange(len(cold_index)))
        self.index = self.index._replace(
            itemid=self.index.itemid._replace(
                cold_start=cold_index.reset_index(drop=True)))

    def _sort_by_cold_items(self):
        cold_index = self.index.itemid.cold_start
        cold_index.sort_values("new", inplace=True)
        self._test.holdout.sort_values(self.cold_itemid, inplace=True)

    # --- external test data --------------------------------------------------

    def set_test_data(self, *, holdout: pd.DataFrame, **kwargs):
        itemid = self.fields.itemid
        if self.cold_itemid not in holdout.columns:
            holdout = holdout.rename(columns={itemid: self.cold_itemid})
        super().set_test_data(holdout=holdout, **kwargs)
        self._post_process_cold_items()


class ColdSimilarityMixin:
    """Cold×seen similarity slices from the side-relations matrices
    (reference ``coldstart/data.py:228-259``)."""

    @property
    def cold_items_similarity(self):
        return self.get_cold_similarity(self.fields.itemid)

    @property
    def cold_users_similarity(self):
        return self.get_cold_similarity(self.fields.userid)

    def get_cold_similarity(self, entity: str):
        sim_mat = self._rel_mat.get(entity)
        if sim_mat is None:
            return None
        fields = self.fields
        entity_type = fields._fields[fields.index(entity)]
        index_data = getattr(self.index, entity_type)

        seen_old = index_data.training["old"].values
        cold_old = index_data.cold_start["old"].values
        # mirror SideRelationsMixin: absent ids map to NaN and an int cast
        # would yield garbage row positions
        try:
            seen_pos = self._relations_positions(entity, seen_old)
            cold_pos = self._relations_positions(entity, cold_old)
        except KeyError:
            raise KeyError(
                f"some of the {entity} ids are missing from the "
                "similarity index") from None
        return sim_mat.index_select(0, cold_pos).index_select(1, seen_pos)


class ItemColdStartSimilarityData(ColdSimilarityMixin, IdentityDiagonalMixin,
                                  SideRelationsMixin, ItemColdStartData):
    pass
