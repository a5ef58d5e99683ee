"""CoFFee: polarity-aware third-order Tucker model.

Counterpart of :mod:`polara_tpu.models.coffee` (reference ``CoffeeModel``,
``polara/recommender/models.py:901-1092``): HOOI factorization of the
user x item x feedback-level tensor (:mod:`polara_tpu_torch.ops.hooi`),
scored by projecting each test profile through the item and feedback
factors.

Scoring: the flattener reduces the feedback factor to a rank-r2 vector,
so the reference's (users x r1 x r2) contraction collapses per event to
one scalar ``alpha = w[level] · flatten(w)``.  Scoring is then the SVD
shape, ``proj = Σ alpha · V[item]`` per user (a sorted segment sum, the
same bits on every call) times ``Vᵀ``, and runs through the fused kernel
on the card exactly as ``SVDModel`` does.  The model reads the data in
tensor mode: the test plan holds feedback-level indices, not ratings.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from polara_tpu_torch import config as defaults
from polara_tpu_torch.models.base import RecommenderModel
from polara_tpu_torch.ops.hooi import (flatten_feedback_weights, hooi,
                                       round_core)
from polara_tpu_torch.ops.scoring import TestChunk
from polara_tpu_torch.ops.sparse import dense_from_coo, sorted_rows_matmul
from polara_tpu_torch.runtime.timing import track_time


class CoffeeModel(RecommenderModel):
    is_tensor_model = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._mlrank = defaults.get_default("mlrank")
        self.factors: dict = {}
        self.method = "CoFFee"
        self._flattener = defaults.get_default("flattener")
        self.growth_tol = defaults.get_default("growth_tol")
        self.num_iters = defaults.get_default("num_iters")
        self.show_output = defaults.get_default("show_output")
        self.seed: Optional[int] = None
        # optional (u_item, u_feedback) start panels for HOOI (checkpoint
        # resume, parity runs); None = the seeded random start
        self.init_factors = None
        # the relative core growth of each sweep of the last build
        self.growth_history: tuple = ()

    @property
    def mlrank(self):
        return self._mlrank

    @mlrank.setter
    def mlrank(self, new_value):
        if new_value != self._mlrank:
            self._mlrank = new_value
            self._check_reduced_rank(new_value)
            self._recommendations = None

    @property
    def flattener(self):
        return self._flattener

    @flattener.setter
    def flattener(self, new_value):
        if new_value != self._flattener:
            self._flattener = new_value
            self._recommendations = None

    def _check_reduced_rank(self, mlrank) -> None:
        """Core-rounding rank reduction (reference ``models.py:949-980``):
        lowering any mode's rank rotates the cached factors through an SVD
        of the unfolded core instead of re-running HOOI."""
        for mode, entity in enumerate(self.data.fields):
            factor = self.factors.get(entity)
            if factor is None:
                continue
            rank = mlrank[mode]
            if factor.shape[1] < rank:
                self._is_ready = False
                self.factors = {}
                return
            if factor.shape[1] == rank:
                continue
            self.factors = dict(**self.factors)
            rotation, core = round_core(
                self.factors["core"].cpu().numpy(), mode, rank)
            self.factors[entity] = factor @ torch.as_tensor(
                rotation, dtype=factor.dtype, device=factor.device)
            self.factors["core"] = torch.as_tensor(core).to(factor.device)

    # scores_multiplier stays at the base class's 1: scoring collapses each
    # event to a scalar weight before the item contraction, so no rank^2
    # intermediate exists (see the module docstring)

    def build(self):
        idx, val, shp = self.data.to_coo(tensor_mode=True)
        budget = int(defaults.get_default("hbm_score_budget_gb") * 2 ** 30)
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        mesh = self.active_mesh

        # the dense tensor, cached on the data object across rebuilds (rank
        # sweeps) while it fits the budget; the verbose loop and the mesh
        # trainer run on the events, so they skip it
        dense_tensor = None
        if (not self.show_output and mesh is None
                and int(np.prod(shp)) * itemsize <= budget):
            cache = self.data.__dict__.setdefault("_device_matrix_cache", {})
            # keyed by dtype and device: the cache is shared by every model
            # of this data, and an f64 build must not take an f32 tensor
            key = ("coffee_tensor", self.compute_dtype, self.device)
            dense_tensor = cache.get(key)
            if dense_tensor is None or tuple(dense_tensor.shape) != shp:
                dense_tensor = cache[key] = dense_from_coo(
                    idx, np.asarray(val, np.float64), shp,
                    dtype=self.compute_dtype, device=self.device)

        with track_time(self.training_time, verbose=self.verbose,
                        model=self.method):
            if mesh is not None:
                from polara_tpu_torch.parallel.distributed import \
                    distributed_hooi
                result = distributed_hooi(
                    idx, val, shp, self.mlrank, mesh,
                    num_iters=self.num_iters, growth_tol=self.growth_tol,
                    seed=self.seed, dtype=self.compute_dtype,
                    verbose=self.show_output,
                    init_factors=self.init_factors)
            else:
                result = hooi(idx, val, shp, self.mlrank,
                              num_iters=self.num_iters,
                              growth_tol=self.growth_tol, seed=self.seed,
                              dtype=self.compute_dtype,
                              verbose=self.show_output,
                              dense_tensor=dense_tensor,
                              init_factors=self.init_factors,
                              device=self.device)
        userid, itemid, feedback = self.data.fields
        self.factors[userid] = result.u0
        self.factors[itemid] = result.u1
        self.factors[feedback] = result.u2
        self.factors["core"] = result.core
        self.growth_history = result.growth_history

    # --- factors given without a build ---------------------------------------

    def set_factors(self, factors) -> None:
        """Install trained factors (user, item and feedback factors and
        ``core``, e.g. a JAX model's through
        :func:`~polara_tpu_torch.runtime.convert.factors_from_jax`) and make
        the model ready without a build; the data's feedback-level index
        is made here if no tensor-mode build made it."""
        super().set_factors(factors)
        self._attach_feedback_index()

    def load(self, path: str):
        meta = super().load(path)
        self._attach_feedback_index()
        return meta

    def _attach_feedback_index(self) -> None:
        if self.data.index.feedback is None:
            self.data.to_coo(tensor_mode=True)
        levels = self.factors.get(self.data.fields.feedback)
        n_levels = self.data.index.feedback.shape[0]
        if levels is not None and levels.shape[0] != n_levels:
            raise ValueError(f"the feedback factor has {levels.shape[0]} "
                             f"rows; the training data has {n_levels} "
                             "feedback levels")

    def _feedback_index(self):
        """The data's feedback-level index (``old`` rating -> ``new``
        level), which a tensor-mode ``to_coo`` creates."""
        index = self.data.index.feedback
        if index is None:
            raise ValueError(
                f"{self.method} needs the data's feedback-level index, "
                "which build() (or set_factors/load) creates; the data "
                "has none yet")
        return index

    def _get_test_data(self, feedback_threshold=None):
        self._feedback_index()
        return super()._get_test_data(feedback_threshold)

    # --- scoring -------------------------------------------------------------

    def score_params(self) -> dict:
        itemid = self.data.fields.itemid
        w = self.factors[self.data.fields.feedback].cpu().numpy()
        wt_flat = flatten_feedback_weights(w, self.flattener)
        if wt_flat.ndim != 1:
            raise ValueError("flattener must reduce the feedback factor to "
                             "a vector")
        # per-feedback-level scalar weights: alpha_f = w[f] . wt_flat
        level_weights = torch.as_tensor(w @ wt_flat).to(
            device=self.device, dtype=self.compute_dtype)
        return {"item_factors": self.factors[itemid],
                "level_weights": level_weights,
                "item_panel": self.factors[itemid]}

    @staticmethod
    def proj_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        """``Σ alpha[level] · V[item]`` per user row as a sorted segment sum
        over the chunk's row-sorted events (``chunk.vals`` holds the
        feedback-level index in tensor mode): the same bits on every
        call.  Padding events become zero terms of the last row."""
        v = params["item_factors"]
        n_rows = chunk.users.shape[0]
        alpha = params["level_weights"][chunk.vals.long()]
        alpha = torch.where(chunk.valid, alpha, 0.0)
        rows = torch.where(chunk.valid, chunk.rows, n_rows - 1)
        return sorted_rows_matmul(rows, chunk.cols, alpha, v, n_rows)

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        return CoffeeModel.proj_chunk(params, chunk) @ params["item_panel"].T

    def predict_feedback(self) -> np.ndarray:
        """Rating prediction for the holdout: argmax over the feedback
        axis of the per-event core response (reference
        ``models.py:1068-1092``)."""
        if self.data.warm_start:
            raise NotImplementedError(
                "feedback prediction needs known users")
        userid, itemid, feedback = self.data.fields
        holdout = self.data.test.holdout
        users = torch.as_tensor(holdout[userid].values.astype(np.int64),
                                device=self.device)
        items = torch.as_tensor(holdout[itemid].values.astype(np.int64),
                                device=self.device)
        u = self.factors[userid]
        v = self.factors[itemid]
        w = self.factors[feedback]
        g = self.factors["core"]
        # scores[e, f] = w[f] . (G x0 u[user_e] x1 v[item_e])
        gu = torch.einsum("abc,ea->ebc", g, u[users])
        guv = torch.einsum("ebc,eb->ec", gu, v[items])
        predictions = torch.argmax(guv @ w.T, dim=-1).cpu().numpy()
        feedback_map = self._feedback_index().set_index("new")
        return feedback_map.loc[predictions, "old"].values

    def get_holdout_slice(self, start, stop):
        """Holdout (user_row, item) pairs for a contiguous user-row range
        (reference ``models.py:1056-1064``)."""
        userid = self.data.fields.userid
        itemid = self.data.fields.itemid
        holdout = self.data.test.holdout
        user_sel = (holdout[userid] >= start) & (holdout[userid] < stop)
        holdout_users = holdout.loc[user_sel, userid].values \
            .astype(np.int64) - start
        holdout_items = holdout.loc[user_sel, itemid].values \
            .astype(np.int64)
        return (holdout_users, holdout_items)
