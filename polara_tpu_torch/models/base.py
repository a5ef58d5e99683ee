"""Recommender model base class.

Counterpart of :class:`polara_tpu.models.base.RecommenderModel` (reference
``polara/recommender/models.py:70-604``) on one device:

* subclasses implement ``build()`` and a ``score_chunk(params, chunk)``
  staticmethod returning a dense (chunk_users x n_items) score block;
  factor models also ``proj_chunk`` plus an ``"item_panel"`` param, which
  unlocks the fused kernel (``fused_scoring`` config);
* the base class owns the chunked scoring loop
  (:mod:`polara_tpu_torch.ops.scoring`) and ``evaluate()``.

``device`` (default: the card; without one, name the CPU) is where the
training block, the factors and the scoring run.  ``mesh`` (or the default
mesh of :func:`~polara_tpu_torch.runtime.mesh.use_mesh`) routes the build
and the scoring over a device mesh; its first entry should be ``device``,
where the results gather.  This module imports no pandas; it reads the
data model's frames only through their methods.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch import config as defaults
from polara_tpu_torch.evaluation.metrics import (Experience, Hits, Ranking,
                                                 Relevance, SimpleRanking,
                                                 SimpleRelevance,
                                                 compute_metrics)
from polara_tpu_torch.ops.scoring import (ChunkedTestData, TestChunk,
                                          run_scoring, run_scoring_fused)
from polara_tpu_torch.ops.sparse import (CooMatrix, coo_from_arrays,
                                         dense_from_coo)
from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.mesh import (Mesh, get_default_mesh,
                                           shard_device_count)


def _flush_before_build(build_func):
    @functools.wraps(build_func)
    def wrapper(self, *args, **kwargs):
        self._is_ready = False
        self._recommendations = None
        self._test_plan = None
        result = build_func(self, *args, **kwargs)
        self._is_ready = True
        return result
    return wrapper


class RecommenderModel:
    _config = ("topk", "filter_seen", "switch_positive",
               "feedback_threshold", "verify_integrity")

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "build" in cls.__dict__:
            cls.build = _flush_before_build(cls.__dict__["build"])

    def __init__(self, recommender_data, feedback_threshold=None,
                 device: Union[str, torch.device, None] = None,
                 mesh: Optional[Mesh] = None):
        self.data = recommender_data
        self.device = resolve_device(device, type(self).__name__)
        # an explicit mesh routes factorization and scoring through the
        # distributed paths; None defers to the framework default
        self.mesh = mesh
        self._recommendations = None
        self._test_plan: Optional[ChunkedTestData] = None
        self._scoring_device_output = False
        self._test_users: Optional[np.ndarray] = None
        self.method = "ABC"

        self._topk = defaults.get_default("topk")
        self._filter_seen = defaults.get_default("filter_seen")
        self._feedback_threshold = (feedback_threshold
                                    or defaults.get_default(
                                        "feedback_threshold"))
        self.switch_positive = defaults.get_default("switch_positive")
        self.verify_integrity = defaults.get_default("verify_integrity")
        self.compute_dtype = getattr(torch,
                                     defaults.get_default("compute_dtype"))

        self._prediction_key = self.data.fields.userid
        self._prediction_target = self.data.fields.itemid

        self._is_ready = False
        self.verbose = True
        self.training_time: list = []

        self.data.subscribe(self.data.on_change_event, self._renew_model)
        self.data.subscribe(self.data.on_update_event, self._refresh_model)

    # --- cache lifecycle ----------------------------------------------------

    @property
    def recommendations(self) -> np.ndarray:
        self._ensure_recommendations()
        if isinstance(self._recommendations, torch.Tensor):
            # evaluate() left the cache on the device; the public property
            # contract is a host array
            self._recommendations = self._recommendations.cpu().numpy()
        return self._recommendations

    def _device_recommendations(self) -> torch.Tensor:
        """The recommendation cache as a tensor on the model's device
        (evaluate() consumes it there)."""
        self._ensure_recommendations()
        return torch.as_tensor(self._recommendations).to(self.device)

    def _ensure_recommendations(self) -> None:
        if self._recommendations is not None:
            return
        self._scoring_device_output = True
        try:
            if not self._is_ready:
                if self.verbose:
                    print(f"{self.method} model is not ready. Rebuilding.")
                self.build()
            self._recommendations = self.get_recommendations()
        finally:
            self._scoring_device_output = False

    def _renew_model(self):
        self._recommendations = None
        self._test_plan = None
        self._is_ready = False

    def _refresh_model(self):
        self._recommendations = None
        self._test_plan = None

    @property
    def topk(self) -> int:
        return self._topk

    @topk.setter
    def topk(self, new_value: int):
        if (self._recommendations is not None
                and new_value > self._recommendations.shape[1]):
            self._recommendations = None  # too short — must recompute
        self._topk = new_value

    @property
    def feedback_threshold(self):
        return self._feedback_threshold

    @feedback_threshold.setter
    def feedback_threshold(self, new_value):
        if self._feedback_threshold != new_value:
            self._feedback_threshold = new_value
            self._renew_model()

    @property
    def filter_seen(self) -> bool:
        return self._filter_seen

    @filter_seen.setter
    def filter_seen(self, new_value: bool):
        if self._filter_seen != new_value:
            self._filter_seen = new_value
            self._refresh_model()

    def get_base_configuration(self) -> Dict[str, Any]:
        return {attr: getattr(self, attr) for attr in self._config}

    @property
    def active_mesh(self) -> Optional[Mesh]:
        """The mesh this model computes over: its own ``mesh`` if set, else
        the framework default (``runtime.mesh.use_mesh``)."""
        if self.mesh is not None:
            return self.mesh
        return get_default_mesh()

    # --- training-data access -----------------------------------------------

    def build(self):
        raise NotImplementedError("implemented by concrete models")

    def set_factors(self, factors: Dict[str, Optional[torch.Tensor]]
                    ) -> None:
        """Install trained factors (e.g. from
        :func:`polara_tpu_torch.runtime.convert.factors_from_jax`) and make
        the model ready without a build."""
        self.factors = {name: (None if value is None
                               else value.to(self.device))
                        for name, value in factors.items()}
        self._recommendations = None
        self._test_plan = None
        self._is_ready = True

    def get_training_matrix(self, feedback_threshold=None,
                            ignore_feedback: bool = False,
                            dense: bool = False,
                            dtype: Optional[torch.dtype] = None
                            ) -> Union[CooMatrix, torch.Tensor]:
        """Training interactions as a COO matrix (or dense block) on the
        model's device, cached on the data object until the training data
        changes, so models sharing a data instance share one copy."""
        threshold = feedback_threshold or self.feedback_threshold
        dtype = dtype or self.compute_dtype
        cache_key = (threshold, ignore_feedback, dense, dtype, self.device)
        cache = self.data.__dict__.setdefault("_device_matrix_cache", {})
        cached = cache.get(cache_key)
        if cached is not None:
            return cached

        idx, val, shp = self.data.to_coo(tensor_mode=False,
                                         feedback_threshold=threshold)
        if ignore_feedback:
            val = np.ones_like(val)
        if dense:
            matrix = dense_from_coo(idx, val, shp, dtype=dtype,
                                    device=self.device)
        else:
            matrix = coo_from_arrays(idx, val, shp, dtype=dtype,
                                     device=self.device)
        cache[cache_key] = matrix
        return matrix

    def get_test_matrix(self, user_slice: Optional[Tuple[int, int]] = None
                        ) -> Tuple[torch.Tensor, np.ndarray]:
        """Dense profile matrix of the test users on the model's device
        (reference ``models.py:180-211`` returns the user-sliced CSR).

        Returns ``(profiles, test_users)`` where row i of ``profiles``
        holds the interactions of ``test_users[i]``."""
        (user_rows, item_idx, feedback), test_shape, test_users = \
            self._get_test_data()
        start, stop = (user_slice if user_slice is not None
                       else (0, test_shape[0]))
        sel = (user_rows >= start) & (user_rows < stop)
        profiles = np.zeros((stop - start, test_shape[1]))
        profiles[user_rows[sel] - start, item_idx[sel]] = \
            np.asarray(feedback, dtype=np.float64)[sel]
        return (torch.as_tensor(profiles).to(device=self.device,
                                             dtype=self.compute_dtype),
                test_users[start:stop])

    # --- test-data plumbing --------------------------------------------------

    @property
    def scores_multiplier(self) -> int:
        return 1

    def _get_test_data(self, feedback_threshold=None):
        # tensor models (CoFFee) read feedback-level indices as values
        tensor_mode = getattr(self, "is_tensor_model", False)
        test_shape = self.data.get_test_shape(tensor_mode=tensor_mode)
        threshold = feedback_threshold or self.feedback_threshold
        if self.data.warm_start:
            if threshold and self.verbose:
                print("Specifying threshold has no effect in warm start.")
            threshold = None
        user_idx, item_idx, feedback = self.data.test_to_coo(
            tensor_mode=tensor_mode, feedback_threshold=threshold)

        diffs = np.diff(user_idx)
        if (diffs < 0).any():
            raise AssertionError("test data must be sorted by user")
        # rebase to contiguous rows aligned with the recommendations matrix
        if (diffs > 1).any() or (len(user_idx) and user_idx.min() != 0):
            test_users = user_idx[np.r_[0, np.where(diffs)[0] + 1]]
            user_rows = np.r_[0, np.cumsum(diffs > 0)].astype(user_idx.dtype)
        else:
            test_users = np.arange(test_shape[0])
            user_rows = user_idx
        return (user_rows, item_idx, feedback), test_shape, test_users

    def _build_test_plan(self) -> Tuple[ChunkedTestData, np.ndarray]:
        # plans (and their packed seen bits) are shared across models with
        # the same effective test view: cached on the data object,
        # invalidated whenever the split changes.  A tensor model's plan
        # holds feedback-level indices where the others hold ratings.
        threshold = (None if self.data.warm_start
                     else self.feedback_threshold)
        n_shards, n_devices = self._mesh_layout()
        key = (getattr(self, "is_tensor_model", False), threshold,
               self.scores_multiplier, self.device, n_shards, n_devices)
        cache = self.data.__dict__.setdefault("_test_plan_cache", {})
        hit = cache.get(key)
        if hit is not None:
            return hit
        (user_rows, item_idx, feedback), test_shape, test_users = \
            self._get_test_data()
        plan = ChunkedTestData.build(
            user_rows, item_idx, np.asarray(feedback, dtype=np.float64),
            n_users=test_shape[0], n_items=test_shape[1],
            scores_multiplier=self.scores_multiplier, device=self.device,
            n_shards=n_shards, n_devices=n_devices)
        cache[key] = (plan, test_users)
        return plan, test_users

    def _mesh_layout(self) -> Tuple[int, int]:
        """The active mesh's users-axis size and the distinct devices its
        shards lie on ((1, 1) without a mesh): the score block row-shards
        over the axis, so chunks align to its size and their budget
        scales by the device count."""
        mesh = self.active_mesh
        if mesh is None:
            return 1, 1
        return (int(mesh.shape[mesh.axis_names[0]]),
                shard_device_count(mesh))

    # --- scoring -------------------------------------------------------------

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        raise NotImplementedError("implemented by concrete models")

    # Factor models additionally expose the ``proj @ panelᵀ`` split
    # (proj_chunk + params["item_panel"]) which unlocks the fused kernel;
    # None means dense-score models (unfused path only).
    proj_chunk = None

    # score_chunk scores each row from that user's events alone, so under
    # a mesh each users shard is scored on its own device; False for
    # scorers that draw one random stream per chunk (a shard would draw
    # another), which score whole chunks on the model's device
    row_local_scores = True

    @classmethod
    def _fused_scoring_capable(cls) -> bool:
        """The fused route is sound only when the effective ``score_chunk``
        and ``proj_chunk`` were declared together."""
        for klass in cls.__mro__:
            has_score = "score_chunk" in klass.__dict__
            has_proj = "proj_chunk" in klass.__dict__
            if has_score or has_proj:
                return (has_score and has_proj
                        and klass.__dict__["proj_chunk"] is not None)
        return False

    def score_params(self) -> dict:
        """Tensors consumed by ``score_chunk``."""
        raise NotImplementedError("implemented by concrete models")

    def uses_fused_scoring(self, params: dict) -> bool:
        """``fused_scoring``: "auto" takes the fused kernel on CUDA, True
        forces the fused route (its plain version on the CPU), False
        never takes it."""
        mode = defaults.get_default("fused_scoring")
        usable = (self._fused_scoring_capable() and self.topk <= 128
                  and "item_panel" in params)
        on_cuda = self.device.type == "cuda"
        return usable and (mode is True or (mode == "auto" and on_cuda))

    def get_recommendations(self):
        if self.verify_integrity:
            self.verify_data_integrity()
        if (self._test_plan is None
                # the plan survives rebuilds, but the chunk budget depends
                # on the mesh: re-plan when the mesh changed since
                or getattr(self, "_test_plan_layout", None)
                != self._mesh_layout()):
            self._test_plan, self._test_users = self._build_test_plan()
            self._test_plan_layout = self._mesh_layout()
        plan, test_users = self._test_plan, self._test_users
        params = dict(self.score_params())
        params["test_users"] = torch.as_tensor(test_users,
                                               device=self.device)
        mesh = self.active_mesh
        if self.uses_fused_scoring(params):
            return run_scoring_fused(
                plan, type(self).proj_chunk, params, topk=self.topk,
                filter_seen=self.filter_seen, n_valid_cols=plan.n_items,
                on_device=self._scoring_device_output,
                item_order=defaults.get_default("fused_item_order"),
                mesh=mesh)
        return run_scoring(plan, type(self).score_chunk, params,
                           topk=self.topk, filter_seen=self.filter_seen,
                           n_valid_cols=plan.n_items,
                           on_device=self._scoring_device_output,
                           mesh=mesh if self.row_local_scores else None)

    # --- single-user convenience ---------------------------------------------

    def _user_scores(self, i: int):
        if not self._is_ready:
            if self.verbose:
                print(f"{self.method} model is not ready. Rebuilding.")
            self.build()
        (user_rows, item_idx, feedback), test_shape, test_users = \
            self._get_test_data()
        if not self.data.warm_start:
            matches = np.where(test_users == i)[0]
            if len(matches) != 1:
                raise KeyError(f"user {i} is not among test users")
            i = int(matches[0])
        sel = user_rows == i
        plan = ChunkedTestData.build(
            np.zeros(int(sel.sum()), dtype=np.int64), item_idx[sel],
            np.asarray(feedback, dtype=np.float64)[sel],
            n_users=1, n_items=test_shape[1],
            scores_multiplier=self.scores_multiplier, device=self.device)
        params = dict(self.score_params())
        params["test_users"] = torch.as_tensor([i], device=self.device)
        scores = type(self).score_chunk(params, plan.chunks[0])
        seen = (np.zeros(int(sel.sum()), dtype=np.int64), item_idx[sel])
        return scores.cpu().numpy(), seen

    def _make_user(self, user_info):
        """A one-user test frame from an item list (feedback: the top
        training value) or an ``{item: feedback}`` dict."""
        import pandas as pd

        userid, itemid, feedback = self.data.fields
        if isinstance(user_info, dict):
            items_data, feedback_data = zip(*user_info.items())
            feedback_frame = {feedback: list(feedback_data)}
        elif isinstance(user_info, (list, tuple, set, np.ndarray)):
            items_data = list(user_info)
            feedback_frame = {}
            if feedback is not None:
                top_value = self.data.training[feedback].max()
                feedback_frame = {feedback: [top_value] * len(items_data)}
        else:
            raise ValueError("Unrecognized input for user_info")
        item_index = self.data.get_entity_index(itemid)
        internal = item_index.set_index("old").loc[list(items_data),
                                                   "new"].values
        frame = {userid: [0] * len(internal), itemid: internal}
        frame.update(feedback_frame)
        return pd.DataFrame(frame)

    def show_recommendations(self, user_info, topk: Optional[int] = None):
        """Top items (original ids) and the seen items of one test user
        (by id) or of an ad-hoc profile (item list or dict)."""
        from polara_tpu_torch.data.dataset import TestData
        if isinstance(user_info, (int, np.integer)):
            scores, seen = self._user_scores(int(user_info))
        else:
            saved = self.data._test
            try:
                self.data._test = TestData(self._make_user(user_info), None)
                scores, seen = self._user_scores(0)
            finally:
                self.data._test = saved
        k = topk if topk is not None else self.topk
        order = np.argsort(-scores[0])[:k]
        item_index = self.data.get_entity_index(self.data.fields.itemid)
        back = item_index.set_index("new")
        top_recs = back.loc[order, "old"].values
        seen_items = back.loc[seen[1], "old"].values
        return top_recs, seen_items

    # --- evaluation -----------------------------------------------------------

    def evaluate(self, metric_type="all", topk: Optional[int] = None,
                 not_rated_penalty: Optional[float] = None,
                 switch_positive: Optional[float] = None,
                 ignore_feedback: bool = False,
                 simple_rates: bool = False):
        """Compute metric families over the holdout
        (reference ``models.py:408-485``)."""
        if metric_type == "all":
            metric_type = ["hits", "relevance", "ranking", "experience"]
        elif metric_type == "main":
            metric_type = ["relevance", "ranking"]
        if not isinstance(metric_type, (list, tuple)):
            metric_type = [metric_type]

        if int(topk or 0) > self.topk:
            self.topk = topk  # flushes stale recommendations
        recommendations = self._device_recommendations()[:, :topk]

        switch_positive = switch_positive or self.switch_positive
        feedback = self.data.fields.feedback
        holdout = self.data.test.holdout
        if switch_positive is None or feedback is None:
            # implicit-feedback regime: every unrated recommendation is an
            # honest false positive
            not_rated_penalty = (1 if not_rated_penalty is None
                                 else not_rated_penalty)
            is_positive = None
        else:
            not_rated_penalty = not_rated_penalty or 0
            is_positive = (holdout[feedback] >= switch_positive).values

        feedback_col = None if ignore_feedback else feedback
        coverage_total = None
        if "experience" in metric_type:
            fields = self.data.fields
            entity = fields._fields[fields.index(self._prediction_target)] \
                if self._prediction_target in fields else "itemid"
            entity_index = getattr(self.data.index, entity)
            entity_index = getattr(entity_index, "training", entity_index)
            coverage_total = int(entity_index.shape[0])
        stats = compute_metrics(
            recommendations, holdout,
            key=self._prediction_key, target=self._prediction_target,
            feedback=feedback_col, is_positive=is_positive,
            switch_positive=switch_positive,
            not_rated_penalty=not_rated_penalty,
            topk=recommendations.shape[1],
            alternative=defaults.get_default("ndcg_alternative"),
            coverage_total=coverage_total)

        simple = (self.data.holdout_size == 1) or simple_rates
        has_split = is_positive is not None
        scores = []
        if "relevance" in metric_type:
            if simple:
                scores.append(SimpleRelevance(hr=stats["hr"]))
            else:
                scores.append(Relevance(
                    precision=stats["precision"], recall=stats["recall"],
                    fallout=stats["fallout"] if has_split else None,
                    specifity=stats["specifity"] if has_split else None,
                    miss_rate=stats["miss_rate"]))
        if "ranking" in metric_type:
            if simple:
                scores.append(SimpleRanking(arhr=stats["arhr"],
                                            mrr=stats["mrr"]))
            else:
                scores.append(Ranking(
                    ndcg=stats["ndcg"],
                    ndcl=stats["ndcl"] if has_split else None,
                    map=stats["map"], arhr=stats["arhr"]))
        if "experience" in metric_type:
            scores.append(Experience(coverage=stats["coverage"]))
        if "hits" in metric_type:
            scores.append(Hits(
                true_positive=stats["tp"], false_positive=stats["fp"],
                true_negative=stats["tn"] if has_split else None,
                false_negative=stats["fn"]))
        if not scores:
            raise ValueError(f"Unknown metric types: {metric_type}")
        return scores[0] if len(scores) == 1 else scores

    # --- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist trained factors (+ method metadata) to an npz artifact
        that either package loads (see
        :mod:`polara_tpu_torch.runtime.checkpoint`)."""
        from polara_tpu_torch.runtime.checkpoint import save_factors
        factors = getattr(self, "factors", None)
        if not factors:
            raise ValueError(f"{self.method} has no trained factors to "
                             "save; build() first")
        meta = {"method": self.method, "class": type(self).__name__}
        rank = getattr(self, "rank", None)
        if isinstance(rank, (int, float)):
            meta["rank"] = int(rank)
        save_factors(path, factors, meta)

    def load(self, path: str) -> Dict[str, Any]:
        """Restore factors saved by :meth:`save` (by either package) onto
        the model's device; the model becomes ready without retraining
        (rank truncation still applies on top)."""
        from polara_tpu_torch.runtime.checkpoint import load_factors
        factors, meta = load_factors(path, device=self.device)
        self.factors = factors
        self._recommendations = None
        self._test_plan = None
        self._is_ready = True
        # sync the rank attribute with what was loaded
        if "rank" in meta and hasattr(self, "_rank"):
            self._rank = int(meta["rank"])
        return meta

    # --- invariants -----------------------------------------------------------

    def verify_data_integrity(self):
        """Index/factor consistency checks (reference ``models.py:581``)."""
        data = self.data
        userid, itemid, feedback = data.fields
        item_index = getattr(data.index.itemid, "training", data.index.itemid)
        nunique_items = data.training[itemid].nunique()
        if not (nunique_items == item_index.shape[0]
                == data.training[itemid].max() + 1):
            raise AssertionError("item index is inconsistent with the "
                                 "training data")
        factors = getattr(self, "factors", None)
        if factors:
            item_factors = factors.get(itemid)
            if (item_factors is not None
                    and item_factors.shape[0] != item_index.shape[0]):
                raise AssertionError("item factors do not match the item "
                                     "index")


class EmbeddingsMixin:
    @property
    def user_embeddings(self):
        return self.factors[self.data.fields.userid]

    @property
    def item_embeddings(self):
        return self.factors[self.data.fields.itemid]
