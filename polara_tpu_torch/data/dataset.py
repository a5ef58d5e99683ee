"""Stateful interaction-data model.

Host-side (pandas) copy of :mod:`polara_tpu.data.dataset`, itself the
counterpart of the reference data model
(``polara/recommender/data.py:99-936``).  It owns a deduplicated interaction
log, performs scenario-driven train/test splitting (see
:mod:`polara_tpu_torch.data.scenario`), contiguous reindexing of entity ids,
lazy invalidation through config properties, and pub/sub notification of
models.

The device boundary sits at the export methods: :meth:`to_coo` /
:meth:`test_to_coo` produce numpy COO data which the ops layer turns into
device tensors.  Everything in this module is deliberately CPU/pandas.
Top-rated holdout selection over 100k events and more runs through the
native per-group top-k (:mod:`polara_tpu_torch.native`), as in the JAX
package.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Any, Dict, Optional, Sequence

import numpy as np
import pandas as pd

from polara_tpu_torch import config as defaults
from polara_tpu_torch import native
from polara_tpu_torch.data.events import EventNotifier
from polara_tpu_torch.data.scenario import (UpdateRule, plan_update,
                                            validate_config)

Fields = namedtuple("Fields", ["userid", "itemid", "feedback"])
DataIndex = namedtuple("DataIndex", ["userid", "itemid", "feedback"])
UserIndex = namedtuple("UserIndex", ["training", "test"])
TestData = namedtuple("TestData", ["testset", "holdout"])

# config attributes that participate in lazy invalidation
_CONFIG_PROPS = ("test_ratio", "test_fold", "shuffle_data", "test_sample",
                 "warm_start", "holdout_size", "permute_tops",
                 "random_holdout", "negative_prediction")


def build_entity_index(data: pd.DataFrame, col: str, sort: bool = True,
                       inplace: bool = True):
    """Contiguous 0..n-1 reindexing of a column.

    Returns the old->new mapping frame; with ``inplace`` the column is
    replaced by the codes (reference ``data.py:702-715``).
    """
    codes, uniques = pd.factorize(data[col], sort=sort)
    mapping = pd.DataFrame({"old": uniques, "new": np.arange(len(uniques))})
    if inplace:
        # whole-column replacement, not .loc setitem: factorize yields
        # int64 codes and pandas>=3 refuses to silently downcast them
        # into a narrower (e.g. int32) id column
        data[col] = codes
        return mapping
    return codes, mapping


# the native holdout path takes over from pandas at this many events
NATIVE_HOLDOUT_MIN_EVENTS = 100_000


def native_top_positions(groups: np.ndarray, values: np.ndarray,
                         size: int) -> np.ndarray:
    """Positions of the ``size`` largest ``values`` of every group, in the
    order of pandas ``groupby(sort=False).nlargest(size, keep="last")``:
    groups by first appearance, then value descending, later first among
    ties.  Runs :func:`polara_tpu_torch.native.group_top_k`."""
    codes, _ = pd.factorize(groups, sort=False)
    values = np.asarray(values, dtype=np.float64)
    picked, _ = native.group_top_k(
        codes.astype(np.int32), values,
        int(codes.max()) + 1 if len(codes) else 0, int(size))
    order = np.lexsort((-picked, -values[picked], codes[picked]))
    return picked[order]


def _config_property(name: str):
    internal = "_" + name

    def getter(self):
        if name in self._pending_changes and self.verbose:
            print(f"The value of {name} might be not effective yet.")
        return getattr(self, internal)

    def setter(self, value):
        if getattr(self, internal) != value:
            setattr(self, internal, value)
            self._pending_changes.add(name)

    return property(getter, setter)


class RecommenderData:
    """Owns the interaction log and the train/test split lifecycle."""

    on_change_event = "on_change"   # training changed -> models rebuild
    on_update_event = "on_update"   # test data changed -> models re-predict

    for _p in _CONFIG_PROPS:
        locals()[_p] = _config_property(_p)
    del _p

    def __init__(self, data: Optional[pd.DataFrame], userid: str, itemid: str,
                 feedback: Optional[str] = None,
                 custom_order: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 seed: Optional[int] = None, verbose: bool = True):
        self.name = None
        fields = [userid, itemid, feedback]
        if data is None:
            cols = [c for c in fields + [custom_order] if c]
            data = pd.DataFrame(columns=cols)

        present = [f for f in fields if f]
        if data.duplicated(subset=present).any():
            raise ValueError("Interaction data contains duplicate "
                             "(user, item) records; deduplicate first.")
        if not data.index.is_unique:
            data = data.reset_index(drop=True)

        self._data = data
        self._custom_order = custom_order
        self.fields = Fields(userid, itemid, feedback)
        self.index = DataIndex(None, None, None)

        for name, value in defaults.get_config(_CONFIG_PROPS).items():
            setattr(self, "_" + name, value)
        # non-empty set marks the uninitialized state: the first access of
        # training/test triggers a split
        self._pending_changes = {"init"}
        if config is not None:
            self.set_configuration(config)
        self.seed = seed

        self.verify_sessions_length_distribution = True
        self.ensure_consistency = True  # drop test entities absent in training
        self.build_index = True         # contiguous reindexing on/off
        self._state: Optional[int] = None
        self._last_update_rule: Optional[UpdateRule] = None
        self._test_split = None
        self.holdout_path: Optional[str] = None   # "native" or "pandas"
        self._test: Optional[TestData] = None
        self._training: Optional[pd.DataFrame] = None

        self._notify = EventNotifier([self.on_change_event,
                                      self.on_update_event])
        self.verbose = verbose

    def __str__(self):
        return f"{type(self).__name__} with {self.fields}"

    # --- pub/sub ------------------------------------------------------------

    def subscribe(self, event: str, model_callback) -> None:
        self._notify.subscribe(event, model_callback)

    def unsubscribe(self, event: str, model) -> None:
        self._notify.unsubscribe(event, model)

    # --- configuration ------------------------------------------------------

    def get_configuration(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in _CONFIG_PROPS}

    def set_configuration(self, params: Dict[str, Any]) -> None:
        for name, value in params.items():
            if hasattr(type(self), name):
                setattr(self, name, value)
            else:
                print(f"Property {name} is undefined.")

    @classmethod
    def default_configuration(cls) -> Dict[str, Any]:
        return defaults.get_config(_CONFIG_PROPS)

    # --- lazy split lifecycle ----------------------------------------------

    @property
    def test(self) -> TestData:
        self.update()
        return self._test

    @property
    def training(self) -> pd.DataFrame:
        self.update()
        return self._training

    def update(self, training_only: bool = False) -> None:
        if self._pending_changes:
            if training_only:
                self.prepare_training_only()
            else:
                self.prepare()

    def prepare(self) -> None:
        if self.verbose:
            print("Preparing data...")
        rule = self._split_data()
        if rule.full_update:
            self._reindex_training_data()
        if rule.any:
            self._drop_unseen_test_items()
            self._drop_unseen_test_users()
            self._drop_invalid_test_users()
            self._reindex_test_data()
            self._sort_test_data()
        if self.verbose:
            n_train = 0 if self._training is None else self._training.shape[0]
            holdout = self._test.holdout if self._test else None
            n_hold = 0 if holdout is None else holdout.shape[0]
            print(f"Done.\nThere are {n_train} events in the training and "
                  f"{n_hold} events in the holdout.")

    def prepare_training_only(self) -> None:
        self.holdout_size = 0
        self.test_ratio = 0
        self.warm_start = False
        self.prepare()

    # --- splitting ----------------------------------------------------------

    def _plan_update(self, changed: frozenset):
        """State-machine step (overridable hook — cold start extends it)."""
        return plan_update(self._state, changed, self._holdout_size,
                           self._test_ratio, self._warm_start,
                           self._random_holdout)

    def _split_data(self) -> UpdateRule:
        validate_config(self._holdout_size, self._test_ratio,
                        self._test_fold, self._warm_start)
        new_state, rule = self._plan_update(frozenset(self._pending_changes))

        if not rule.any:
            if self.verbose:
                print("Data is ready. No action was taken.")
            return rule

        if self._test_ratio > 0:
            test_split = (self._split_test_index() if rule.full_update
                          else self._test_split)
            if self._holdout_size == 0:  # scenario 11
                testset = holdout = None
                train_split = ~test_split
            else:
                holdout = self._sample_holdout(test_split)
                if self._warm_start:  # scenario 4
                    testset = self._sample_testset(test_split, holdout.index)
                    train_split = ~test_split
                else:  # scenario 3: testset recovered lazily from training
                    testset = None
                    train_split = ~self._data.index.isin(holdout.index)
        else:
            testset = None
            test_split = slice(None)
            if self._holdout_size > 0:  # scenario 2 (count or fraction)
                holdout = self._sample_holdout(test_split)
            else:  # scenario 1
                holdout = None
            train_split = (slice(None) if holdout is None
                           else ~self._data.index.isin(holdout.index))

        self._state = new_state
        self._test_split = test_split
        self._test = TestData(testset, holdout)
        # test-side memos (recovered scenario-3 testset, shared scoring
        # plans) follow the test data's lifetime
        self._recovered_testset = None
        self.__dict__.setdefault("_test_plan_cache", {}).clear()

        if rule.full_update:
            fields = [f for f in self.fields if f is not None]
            if self._custom_order:
                fields.append(self._custom_order)
            self._training = self._data.loc[train_split, fields]
            # row mask of the training split over the full frame — lets
            # the reindexing step reuse the memoized full factorization
            self._train_positions = (
                np.ones(len(self._data), bool)
                if isinstance(train_split, slice)
                else np.asarray(train_split))
            # device-resident training blocks are shared across all
            # models of this data instance (models/base.py
            # get_training_matrix) — drop them with the training frame
            self.__dict__.setdefault("_device_matrix_cache", {}).clear()
            self._notify(self.on_change_event)
        elif rule.test_update:
            self._notify(self.on_update_event)

        self._last_update_rule = rule
        self._pending_changes.clear()
        return rule

    # --- fold selection -----------------------------------------------------

    def _split_test_index(self) -> pd.Series:
        user_codes, n_users = self._session_codes()
        return self._fold_mask(user_codes, n_users, self._test_fold,
                               self._test_ratio)

    @staticmethod
    def _column_fingerprint(column: pd.Series):
        """Cheap (length, 64-sample) content token guarding the memo
        below against in-place mutation of the shared events frame."""
        vals = column.values
        n = len(vals)
        if not n:
            return (0, b"")
        idx = np.linspace(0, n - 1, num=min(64, n), dtype=np.int64)
        sample = vals[idx]
        try:
            token = sample.tobytes()
        except (AttributeError, TypeError):   # object dtype (string ids)
            token = str(sample.tolist()).encode()
        return (n, token)

    def _full_codes(self, col: str):
        """Sorted factorization of a full-data column, memoized — the
        events frame does not change across fold updates, yet the fold
        loop used to re-hash it every ``update()`` (the dominant host
        cost of a CV sweep at ML-10M scale: ~25 s per fold on the
        profiled host).  A content sample is validated on every hit so
        in-place mutation of the caller-shared frame drops the whole
        memo instead of silently serving stale codes."""
        cache = self.__dict__.setdefault("_factorize_cache", {})
        column = self._data[col]
        hit = cache.get(col)
        if hit is not None:
            codes, uniques, fp = hit
            if fp == self._column_fingerprint(column):
                return codes, uniques
            cache.clear()           # frame mutated: every memo is stale
        codes, uniques = pd.factorize(column, sort=True)
        uniques = np.asarray(uniques)
        cache[col] = (codes, uniques, self._column_fingerprint(column))
        return codes, uniques

    def _session_codes(self):
        userid = self.fields.userid
        codes, uniques = self._full_codes(userid)
        if self.verify_sessions_length_distribution:
            if self.is_not_uniform(codes):
                print("Users are not uniformly ordered! Unable to split test "
                      "set reliably.")
            self.verify_sessions_length_distribution = False
        return codes, len(uniques)

    @staticmethod
    def is_not_uniform(idx: np.ndarray, nbins: int = 10,
                       allowed_gap: float = 0.75) -> bool:
        """Heuristic fold-balance check (reference ``data.py:497-505``)."""
        bins = pd.cut(idx, bins=nbins, labels=False)
        sizes = np.bincount(bins)
        diff = sizes[:-1] - sizes[1:]
        monotonic = (diff < 0).all() or (diff > 0).all()
        huge_gap = (sizes.min() / sizes.max()) < allowed_gap
        return bool(monotonic or huge_gap)

    @staticmethod
    def _sample_capped_groups(codes: np.ndarray, rs, cap: int
                              ) -> np.ndarray:
        """Positions picking ≤ ``cap`` rows per group, issuing the same
        ``rs.choice`` calls in the same first-appearance group order as
        the groupby-apply it replaces (draw-for-draw pinned by the
        reference-parity suite).  NaN keys (factorize code -1) are
        excluded, matching groupby's ``dropna``."""
        valid = codes >= 0
        pos = np.flatnonzero(valid)
        vcodes = codes[valid]
        order = pos[np.argsort(vcodes, kind="stable")]
        sizes = np.bincount(vcodes) if vcodes.size \
            else np.empty(0, np.int64)
        stops = np.cumsum(sizes)
        chunks = []
        for lo, hi, n in zip(stops - sizes, stops, sizes):
            block = order[lo:hi]
            if n > cap:
                block = block[rs.choice(n, cap, replace=False)]
            chunks.append(block)
        return (np.concatenate(chunks) if chunks
                else np.empty(0, np.intp))

    @staticmethod
    def _fold_mask(codes: np.ndarray, n_unique: int, fold: int,
                   ratio: float) -> np.ndarray:
        per_fold = n_unique * ratio
        lo, hi = round((fold - 1) * per_fold), round(fold * per_fold)
        return (codes >= lo) & (codes < hi)

    # --- holdout sampling ---------------------------------------------------

    def _sample_holdout(self, test_split, group_id: Optional[str] = None
                        ) -> pd.DataFrame:
        """Per-user selection of evaluation items.

        Selection modes follow the reference exactly
        (``data.py:718-754``): top-rated (default), worst-rated
        (``negative_prediction``), or uniformly random
        (``random_holdout``), each supporting integer and fractional
        ``holdout_size``; ``permute_tops`` pre-shuffles to randomize ties.

        Deviation: for fractional top-rated holdout (scenario 2 with
        0 < holdout_size < 1) the reference's ``group_largest_fraction``
        keeps the top ``1-frac`` of each user's events in the holdout; here
        ``holdout_size`` means the fraction HELD OUT, consistent with the
        integer mode and with ``random_holdout`` fractions (regression
        test: ``test_fractional_holdout_takes_top_fraction``).  A
        zero-rounded fraction holds out nothing instead of the whole group
        (second deviation, inline below).
        """
        order_field = self._custom_order or self.fields.feedback or []
        at_random = self._random_holdout or (order_field == [])

        selector = self._data.loc[test_split, order_field]
        if self._permute_tops and not at_random:
            rs = np.random.RandomState(self.seed)
            selector = selector.sample(frac=1, random_state=rs)

        group_id = group_id or self.fields.userid
        size = self._holdout_size

        # hot path at scale: the C++ per-group top-k replaces pandas
        # groupby-nlargest (identical keep-last selection); RNG-dependent
        # modes keep the pandas path.  ``holdout_path`` records the route.
        self.holdout_path = "pandas"
        if (not at_random and not self._negative_prediction
                and not self._permute_tops and size >= 1
                and len(selector) >= NATIVE_HOLDOUT_MIN_EVENTS
                and not np.isnan(selector.values.astype(np.float64,
                                                        copy=False)).any()
                and native.native_available()):
            self.holdout_path = "native"
            groups = self._data.loc[selector.index, group_id]
            picked = native_top_positions(groups.to_numpy(),
                                          selector.to_numpy(), int(size))
            return self._data.loc[selector.index[picked]]

        grouper = selector.groupby(self._data[group_id], sort=False,
                                   group_keys=False)
        if at_random:
            rs = np.random.RandomState(self.seed)
            if size >= 1:
                # Vectorized replacement for groupby-apply: no pandas
                # frame per group (~100 s/fold at ML-10M), identical
                # draws (see _sample_capped_groups)
                keys = self._data[group_id].loc[selector.index].to_numpy()
                codes, _ = pd.factorize(keys, sort=False)
                picked = self._sample_capped_groups(codes, rs, size)
                return self._data.loc[selector.index[picked]]
            chosen = grouper.apply(
                lambda g: g.sample(frac=size, random_state=rs))
        elif self._negative_prediction:
            if size < 1:
                raise NotImplementedError(
                    "Fractional negative holdout is not supported")
            chosen = grouper.nsmallest(size, keep="last")
        else:
            if size >= 1:
                chosen = grouper.nlargest(size, keep="last")
            else:
                def top_fraction(group):
                    k = int(round(size * len(group)))
                    if k <= 0:
                        # deviation from the reference's `[-0:]` slice
                        # (which silently holds out the WHOLE group):
                        # a zero-rounded fraction holds out nothing
                        return group.iloc[:0]
                    return group.iloc[np.argpartition(group, -k)[-k:]]
                chosen = grouper.apply(top_fraction)
        return self._data.loc[chosen.index]

    def _sample_testset(self, test_split, holdout_index) -> pd.DataFrame:
        data = self._data[test_split].drop(holdout_index)
        cap = self._test_sample
        if not cap:
            return data
        userid = self.fields.userid
        if cap > 0:
            # same vectorized draw-preserving scheme as _sample_holdout's
            # random path
            rs = np.random.RandomState(self.seed)
            codes, _ = pd.factorize(data[userid].to_numpy(), sort=False)
            picked = self._sample_capped_groups(codes, rs, cap)
            return data.iloc[picked]
        feedback = self.fields.feedback
        idx = (data.groupby(userid, sort=False)[feedback]
                   .nsmallest(-cap).index.get_level_values(1))
        return data.loc[idx]

    # --- reindexing & cleanup ----------------------------------------------

    def _reindex_training_data(self) -> None:
        if not self.build_index:
            return
        userid, itemid, _ = self.fields
        mask = getattr(self, "_train_positions", None)
        if mask is not None and len(self._training):
            # Fast path: derive the per-fold training index from the
            # memoized full-data factorization (integer remaps) instead
            # of re-hashing the training columns every fold.  Produces
            # byte-identical maps to the build_entity_index calls below
            # (the parity suite pins the split pipeline to the reference).
            ucodes_full, uuniq = self._full_codes(userid)
            icodes_full, iuniq = self._full_codes(itemid)
            ucodes = ucodes_full[mask]
            icodes = icodes_full[mask]
            # items reindex sorted: rank among the present sorted olds
            present = np.bincount(icodes, minlength=len(iuniq)) > 0
            iremap = np.cumsum(present) - 1
            item_map = pd.DataFrame(
                {"old": iuniq[present],
                 "new": np.arange(int(present.sum()))})
            # users reindex by order of appearance; session-ordered data
            # keeps each user's training rows contiguous, so the first
            # row of each run IS the first appearance — verified, with a
            # hash-factorize fallback for non-contiguous layouts
            change = np.empty(len(ucodes), bool)
            change[0] = True
            np.not_equal(ucodes[1:], ucodes[:-1], out=change[1:])
            firsts = ucodes[change]
            if len(np.unique(firsts)) == len(firsts):
                uremap = np.empty(len(uuniq), np.int64)
                uremap[firsts] = np.arange(len(firsts))
                user_map = pd.DataFrame(
                    {"old": uuniq[firsts],
                     "new": np.arange(len(firsts))})
                self._training[userid] = uremap[ucodes]
                self._training[itemid] = iremap[icodes]
                self.index = DataIndex(UserIndex(user_map, None),
                                       item_map, None)
                return
            # non-contiguous users: item remap is still valid
            self._training[itemid] = iremap[icodes]
            user_map = build_entity_index(self._training, userid,
                                          sort=False)
            self.index = DataIndex(UserIndex(user_map, None),
                                   item_map, None)
            return
        user_map = build_entity_index(self._training, userid, sort=False)
        item_map = build_entity_index(self._training, itemid, sort=True)
        self.index = DataIndex(UserIndex(user_map, None), item_map, None)

    def get_entity_index(self, entity: str, index_id: str = "training"):
        entity_type = self.fields._fields[self.fields.index(entity)]
        index_data = getattr(self.index, entity_type)
        return getattr(index_data, index_id, index_data)

    def _drop_unseen_test_items(self, mapping: str = "old") -> None:
        if not self.ensure_consistency:
            return
        itemid = self.fields.itemid
        self._filter_unseen_entity(itemid, self._test.testset, "testset",
                                   mapping)
        self._filter_unseen_entity(itemid, self._test.holdout, "holdout",
                                   mapping)

    def _drop_unseen_test_users(self, mapping: str = "old") -> None:
        if self.ensure_consistency and not self._warm_start:
            userid = self.fields.userid
            self._filter_unseen_entity(userid, self._test.holdout, "holdout",
                                       mapping)

    def _filter_unseen_entity(self, entity: str,
                              dataset: Optional[pd.DataFrame],
                              label: str, mapping: str) -> None:
        if dataset is None:
            return
        entity_type = self.fields._fields[self.fields.index(entity)]
        index_data = getattr(self.index, entity_type)
        if index_data is None:
            raise RuntimeError(f"No index for {entity}; run a full update "
                               "before filtering test data")
        seen = getattr(index_data, "training", index_data)[mapping]
        keep = dataset[entity].isin(seen)
        if not keep.all():
            n_dropped_entities = dataset.loc[~keep, entity].nunique()
            n_dropped_events = int((~keep).sum())
            dataset.drop(dataset.index[~keep], inplace=True)
            if self.verbose:
                print(f"{n_dropped_entities} unique {entity} entities within "
                      f"{n_dropped_events} {label} interactions were "
                      "filtered. Reason: not in the training data.")

    def _drop_invalid_test_users(self) -> None:
        if self.holdout_size >= 1:
            self._filter_short_sessions()
        self._align_test_users()

    def _filter_short_sessions(self, group_id: Optional[str] = None) -> None:
        holdout = self._test.holdout
        if holdout is None:
            return
        group_id = group_id or self.fields.userid
        sizes = holdout.groupby(group_id, sort=False).size()
        invalid = sizes[sizes != self.holdout_size].index
        if len(invalid):
            holdout.drop(
                holdout.index[holdout[group_id].isin(invalid)], inplace=True)
            if self.verbose:
                print(f"{len(invalid)} of {len(sizes)} {group_id} entities "
                      "were filtered out from holdout. Reason: incompatible "
                      "number of items.")

    def _align_test_users(self) -> None:
        testset = self._test.testset
        holdout = self._test.holdout
        if testset is None or holdout is None:
            return
        userid = self.fields.userid
        in_testset = holdout[userid].isin(testset[userid].unique())
        in_holdout = testset[userid].isin(holdout[userid].unique())
        if not in_testset.all():
            n_users = holdout.loc[~in_testset, userid].nunique()
            holdout.drop(holdout.index[~in_testset], inplace=True)
            if self.verbose:
                print(f"{n_users} {userid} entities were filtered out from "
                      "holdout. Reason: inconsistent with testset.")
        if not in_holdout.all():
            n_users = testset.loc[~in_holdout, userid].nunique()
            testset.drop(testset.index[~in_holdout], inplace=True)
            if self.verbose:
                print(f"{n_users} {userid} entities were filtered out from "
                      "testset. Reason: inconsistent with holdout.")

    def _reindex_test_data(self) -> None:
        self._assign_test_items_index()
        if not self._warm_start:
            self._assign_test_users_index()
        else:
            self._reindex_test_users()

    def _assign_test_items_index(self) -> None:
        self._map_entity(self.fields.itemid, self._test.testset)
        self._map_entity(self.fields.itemid, self._test.holdout)

    def _assign_test_users_index(self) -> None:
        self._map_entity(self.fields.userid, self._test.testset)
        self._map_entity(self.fields.userid, self._test.holdout)

    def _reindex_test_users(self) -> None:
        userid = self.fields.userid
        test_user_map = build_entity_index(self._test.testset, userid,
                                           sort=False)
        self.index = self.index._replace(
            userid=self.index.userid._replace(test=test_user_map))
        if self._test.holdout is not None:
            mapper = test_user_map.set_index("old").new
            # whole-column assignment: .loc setitem refuses the int64
            # mapped codes when the source id column is narrower
            self._test.holdout[userid] = \
                self._test.holdout[userid].map(mapper)

    def _map_entity(self, entity: str,
                    dataset: Optional[pd.DataFrame]) -> None:
        if dataset is None:
            return
        entity_type = self.fields._fields[self.fields.index(entity)]
        index_data = getattr(self.index, entity_type)
        if index_data is None:
            return
        seen_index = getattr(index_data, "training", index_data)
        mapper = seen_index.set_index("old").new
        # whole-column assignment (see _align_test_users)
        dataset[entity] = dataset[entity].map(mapper)

    def _sort_test_data(self) -> None:
        userid = self.fields.userid
        if self._test.testset is not None:
            self._test.testset.sort_values(userid, inplace=True)
        if self._test.holdout is not None:
            self._test.holdout.sort_values(userid, inplace=True)

    # --- device export ------------------------------------------------------

    @staticmethod
    def threshold_data(idx, val, threshold, filter_values: bool = True):
        """Drop (or zero) entries with feedback below threshold."""
        if threshold is None:
            return idx, val
        keep = val >= threshold
        if filter_values:
            val = val[keep]
            if isinstance(idx, tuple):
                idx = tuple(x[keep] for x in idx)
            else:
                idx = idx[keep, :]
        else:
            val = val.copy()
            val[~keep] = 0
        return idx, val

    def to_coo(self, tensor_mode: bool = False,
               feedback_threshold: Optional[float] = None):
        """Export training data as COO arrays (indices, values, shape).

        In tensor mode feedback values are reindexed to a contiguous
        0..k-1 third axis (reference ``data.py:794-817``).
        """
        userid, itemid, feedback = self.fields
        training = self.training
        if tensor_mode:
            # user/item dims come from the FULL training split so the
            # tensor stays aligned with the entity indexes even when
            # thresholding drops all events of a trailing entity
            n_users = int(training[userid].max()) + 1
            n_items = int(training[itemid].max()) + 1
            # threshold on the raw feedback BEFORE level encoding — the
            # tensor values are all-ones level indicators
            if feedback_threshold is not None:
                training = training[training[feedback]
                                    >= feedback_threshold]
            fb_codes, fb_map = build_entity_index(training, feedback,
                                                 sort=True, inplace=False)
            self.index = self.index._replace(feedback=fb_map)
            idx = np.hstack((training[[userid, itemid]].values,
                             fb_codes[:, np.newaxis]))
            val = np.ones(training.shape[0])
            shp = (n_users, n_items, int(fb_codes.max()) + 1)
            return (idx.astype(np.intp),
                    np.ascontiguousarray(val, dtype=None), shp)
        idx = training[[userid, itemid]].values
        if feedback is None:
            val = np.ones(training.shape[0])
        else:
            val = training[feedback].values
        shp = tuple(idx.max(axis=0) + 1)
        idx, val = self.threshold_data(idx, val, feedback_threshold)
        return idx.astype(np.intp), np.ascontiguousarray(val, dtype=None), shp

    def _recover_testset(self, update_data: bool = False) -> pd.DataFrame:
        """Scenario-3 testset: training interactions of the holdout users."""
        userid = self.fields.userid
        test_users = self.test.holdout[userid].drop_duplicates()
        if self.index.userid.training.new.isin(test_users).all():
            testset = self.training
        else:
            mask = self.training[userid].isin(test_users)
            testset = self.training.loc[mask]
        testset = testset.sort_values(userid)
        if update_data:
            self._test = self._test._replace(testset=testset)
        return testset

    def test_to_coo(self, tensor_mode: bool = False,
                    feedback_threshold: Optional[float] = None):
        userid, itemid, feedback = self.fields
        testset = self.test.testset
        if testset is None:
            if self._warm_start or self.test.holdout is None:
                raise ValueError("Unable to read test data")
            # scenario-3 recovery sorts ~n_test training rows; memoized
            # per split so several models on one data pay it once
            testset = getattr(self, "_recovered_testset", None)
            if testset is None:
                testset = self._recover_testset(update_data=False)
                self._recovered_testset = testset

        user_idx = testset[userid].values.astype(np.intp)
        item_idx = testset[itemid].values.astype(np.intp)
        if tensor_mode:
            mapper = self.index.feedback.set_index("old").new
            fb_idx = testset[feedback].map(mapper)
            if fb_idx.isnull().any():
                raise ValueError("Some feedback values in the test data are "
                                 "absent from the training data")
            return user_idx, item_idx, fb_idx.values.astype(np.intp)
        if feedback is None:
            fb_val = np.ones(testset.shape[0])
        else:
            fb_val = testset[feedback].values
        (user_idx, item_idx), fb_val = self.threshold_data(
            (user_idx, item_idx), fb_val, feedback_threshold,
            filter_values=False)
        return user_idx, item_idx, fb_val

    def get_test_shape(self, tensor_mode: bool = False):
        userid = self.fields.userid
        if self.test.holdout is None:
            num_users = self.test.testset[userid].nunique()
        else:
            num_users = self.test.holdout[userid].nunique()
        item_index = getattr(self.index.itemid, "training", self.index.itemid)
        shape = (num_users, item_index.shape[0])
        if tensor_mode:
            shape = shape + (self.index.feedback.shape[0],)
        return shape

    # --- external test data -------------------------------------------------

    def set_test_data(self, testset: Optional[pd.DataFrame] = None,
                      holdout: Optional[pd.DataFrame] = None,
                      warm_start: bool = False,
                      test_users: Optional[Sequence] = None,
                      reindex: bool = True, ensure_consistency: bool = True,
                      holdout_size: Optional[int] = None,
                      copy: bool = True) -> None:
        """Inject externally prepared test data (reference ``data.py:887``)."""
        if warm_start and testset is None and test_users is None:
            raise ValueError("warm_start=True requires testset or test_users")
        if not warm_start and testset is not None:
            raise ValueError("with warm_start=False provide holdout and/or "
                             "test_users, not testset")
        if test_users is not None and testset is not None:
            raise ValueError("testset and test_users are mutually exclusive")

        if copy:
            testset = testset.copy() if testset is not None else None
            holdout = holdout.copy() if holdout is not None else None

        if test_users is not None:
            fields = [f for f in self.fields if f is not None]
            if self._custom_order:
                fields.append(self._custom_order)
            mask = self._data[self.fields.userid].isin(test_users)
            testset = self._data.loc[mask, fields]

        self._test = TestData(testset, holdout)
        self._recovered_testset = None
        self.__dict__.setdefault("_test_plan_cache", {}).clear()
        self.index = self.index._replace(
            userid=self.index.userid._replace(test=None))
        self._warm_start = warm_start
        self._state = None
        self._last_update_rule = None
        self._test_ratio = -1       # sentinel: external test data in place
        self._holdout_size = holdout_size or -1
        self._notify(self.on_update_event)
        self._pending_changes.clear()

        if testset is None and holdout is None:
            return  # cleanup call

        if ensure_consistency:
            mapping = "old" if reindex else "new"
            self._drop_unseen_test_items(mapping=mapping)
            self._drop_unseen_test_users(mapping=mapping)
        self._drop_invalid_test_users()
        if reindex:
            self._reindex_test_data()
        self._sort_test_data()

        if self.verbose and holdout is not None:
            print(f"Done. There are {self._test.holdout.shape[0]} events in "
                  "the holdout.")
