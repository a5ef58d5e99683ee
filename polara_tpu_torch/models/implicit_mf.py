"""Implicit-feedback models: iALS and BPR, trained on the model's device.

Counterpart of :mod:`polara_tpu.models.implicit_mf`: API parity with the
reference's ``implicit``-library wrappers
(``polara/recommender/external/implicit/ialswrapper.py:13-91``,
``bprwrapper.py:7-76``): the same config surface (rank, alpha/epsilon/
weight_func, regularization, num_epochs) and the same warm-start
folding-in, computed by :mod:`polara_tpu_torch.ops.implicit`.  Known
users score like ``ProbabilisticMF`` (factor lookup, the fused kernel
on the card); warm-start users are folded in, scored against the item
factors and ranked by ``mask_and_topk``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from polara_tpu_torch import config as defaults
from polara_tpu_torch.models.base import EmbeddingsMixin, RecommenderModel
from polara_tpu_torch.models.mf import ProbabilisticMF
from polara_tpu_torch.ops.implicit import (bpr_train, ials_fold_in,
                                           ials_train, ials_train_events)
from polara_tpu_torch.ops.topk import mask_and_topk
from polara_tpu_torch.runtime.timing import track_time


class _RankedFactorModel(EmbeddingsMixin, RecommenderModel):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rank = 10
        self.factors: dict = {}

    @property
    def rank(self) -> int:
        return self._rank

    @rank.setter
    def rank(self, new_value: int):
        if new_value != self._rank:
            self._rank = new_value
            self._is_ready = False
            self._recommendations = None

    def score_params(self) -> dict:
        return {"user_factors": self.factors[self.data.fields.userid],
                "item_factors": self.factors[self.data.fields.itemid],
                "item_panel": self.factors[self.data.fields.itemid]}

    # known-user scoring: factor lookup, the same scorers as PMF
    score_chunk = staticmethod(ProbabilisticMF.score_chunk)
    proj_chunk = staticmethod(ProbabilisticMF.proj_chunk)

    def _warm_start_profiles(self):
        (user_rows, item_idx, feedback), test_shape, _ = \
            self._get_test_data()
        profiles = np.zeros(test_shape)
        profiles[user_rows, item_idx] = feedback
        return (torch.as_tensor(profiles).to(device=self.device,
                                             dtype=self.compute_dtype),
                torch.as_tensor(user_rows, device=self.device),
                torch.as_tensor(item_idx, device=self.device))

    def _fold_in_users(self, profiles: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_recommendations(self):
        if not self.data.warm_start:
            return super().get_recommendations()
        if not self.filter_seen:
            raise ValueError("The model always filters seen items from "
                             "results.")
        profiles, seen_rows, seen_cols = self._warm_start_profiles()
        user_factors = self._fold_in_users(profiles)
        scores = user_factors @ self.factors[self.data.fields.itemid].T
        recs = mask_and_topk(scores, seen_rows, seen_cols,
                             torch.ones(seen_rows.shape[0], dtype=torch.bool,
                                        device=self.device),
                             self.topk, filter_seen=True,
                             n_valid_cols=scores.shape[1])
        return recs if self._scoring_device_output else recs.cpu().numpy()


class ImplicitALS(_RankedFactorModel):
    """'iALS': confidence-weighted alternating least squares."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = 1.0
        self.epsilon = 1.0
        self.weight_func = "log2"
        self.regularization = 0.01
        self.num_epochs = 15
        # None = size each sweep's batch to the memory budget; an int pins
        # both sweeps' batch size
        self.batch_rows: Optional[int] = None
        # event tier: entities solved per window of the tile-aligned event
        # sweeps; None = the ops default (4096)
        self.batch_entities: Optional[int] = None
        self.seed = 0
        self.method = "iALS"

    def build(self):
        mesh = self.active_mesh
        coo = self.get_training_matrix()
        # past the per-device budget the dense ratings block is not made:
        # the event tier computes the same sweeps from the events
        budget = defaults.get_default("hbm_score_budget_gb") * 2 ** 30
        if mesh is not None:
            from polara_tpu_torch.runtime.mesh import shard_device_count
            budget *= shard_device_count(mesh)
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        dense_bytes = coo.shape[0] * coo.shape[1] * itemsize
        if dense_bytes > budget:
            stream_kw = {} if self.batch_entities is None else \
                {"batch_entities": self.batch_entities}
            with track_time(self.training_time, verbose=self.verbose,
                            model=self.method):
                if mesh is not None and mesh.size > 1:
                    from polara_tpu_torch.parallel.distributed import \
                        distributed_ials_events
                    result = distributed_ials_events(
                        coo.rows, coo.cols, coo.vals, coo.shape, self.rank,
                        mesh, alpha=self.alpha, weight=self.weight_func,
                        epsilon=self.epsilon, reg=self.regularization,
                        num_epochs=self.num_epochs, seed=self.seed,
                        dtype=self.compute_dtype, **stream_kw)
                else:
                    result = ials_train_events(
                        coo.rows, coo.cols, coo.vals, coo.shape, self.rank,
                        alpha=self.alpha, weight=self.weight_func,
                        epsilon=self.epsilon, reg=self.regularization,
                        num_epochs=self.num_epochs, seed=self.seed,
                        dtype=self.compute_dtype, device=self.device,
                        **stream_kw)
        else:
            dense = self.get_training_matrix(dense=True)
            with track_time(self.training_time, verbose=self.verbose,
                            model=self.method):
                if mesh is not None:
                    from polara_tpu_torch.parallel.distributed import \
                        distributed_ials
                    result = distributed_ials(
                        dense, self.rank, mesh, alpha=self.alpha,
                        weight=self.weight_func, epsilon=self.epsilon,
                        reg=self.regularization,
                        num_epochs=self.num_epochs, seed=self.seed,
                        batch_rows=self.batch_rows,
                        dtype=self.compute_dtype)
                else:
                    result = ials_train(
                        dense, self.rank, alpha=self.alpha,
                        weight=self.weight_func, epsilon=self.epsilon,
                        reg=self.regularization,
                        num_epochs=self.num_epochs, seed=self.seed,
                        batch_rows=self.batch_rows,
                        dtype=self.compute_dtype)
        self.factors[self.data.fields.userid] = result.user
        self.factors[self.data.fields.itemid] = result.item

    def _fold_in_users(self, profiles: torch.Tensor) -> torch.Tensor:
        return ials_fold_in(profiles,
                            self.factors[self.data.fields.itemid],
                            alpha=self.alpha, weight=self.weight_func,
                            epsilon=self.epsilon, reg=self.regularization,
                            batch_rows=self.batch_rows)


def _lstsq_fold_in(profiles: torch.Tensor, item_factors: torch.Tensor,
                   reg: float) -> torch.Tensor:
    """Ridge fold-in onto fixed item factors over each user's seen set:
    ``(Yᵀ diag(p) Y + reg I) x = Yᵀ p`` with p the binary profile."""
    y = item_factors
    p = (profiles > 0).to(y.dtype)
    a = (torch.matmul((p[:, :, None] * y[None]).transpose(1, 2), y)
         + reg * torch.eye(y.shape[1], dtype=y.dtype, device=y.device)[None])
    rhs = p @ y
    chol = torch.linalg.cholesky(a)
    return torch.cholesky_solve(rhs[..., None], chol)[..., 0]


class ImplicitBPR(_RankedFactorModel):
    """'BPRMF': Bayesian personalized ranking."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.learning_rate = 0.01
        self.regularization = 0.01
        self.num_epochs = 100
        self.batch_size = 1024
        self.seed = 0
        self.show_progress = False
        self.epoch_stats: Optional[list] = None
        self.method = "BPRMF"

    def build(self):
        coo = self.get_training_matrix()
        self.epoch_stats = []
        mesh = self.active_mesh
        with track_time(self.training_time, verbose=self.verbose,
                        model=self.method):
            if mesh is not None:
                from polara_tpu_torch.parallel.distributed import \
                    distributed_bpr
                result = distributed_bpr(
                    coo.rows, coo.cols, coo.shape, self.rank, mesh,
                    learning_rate=self.learning_rate,
                    reg=self.regularization, num_epochs=self.num_epochs,
                    batch_size=self.batch_size, seed=self.seed,
                    dtype=self.compute_dtype,
                    epoch_stats=self.epoch_stats)
            else:
                result = bpr_train(
                    coo.rows, coo.cols, coo.shape, self.rank,
                    learning_rate=self.learning_rate,
                    reg=self.regularization, num_epochs=self.num_epochs,
                    batch_size=self.batch_size, seed=self.seed,
                    dtype=self.compute_dtype, verbose=self.show_progress,
                    epoch_stats=self.epoch_stats, device=self.device)
        self.factors[self.data.fields.userid] = result.user
        self.factors[self.data.fields.itemid] = result.item

    def _fold_in_users(self, profiles: torch.Tensor) -> torch.Tensor:
        return _lstsq_fold_in(profiles,
                              self.factors[self.data.fields.itemid],
                              self.regularization)
