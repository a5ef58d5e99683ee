"""Probabilistic matrix factorization (SGD).

Counterpart of :mod:`polara_tpu.models.mf` (reference ``ProbabilisticMF``,
``polara/recommender/models.py:728-787``, trained by ``simple_pmf_sgd``):
squared-error MF with lambda = sigma^2/2 regularization normalized by
per-row/column interaction counts, trained as minibatch SGD on the model's
device (:func:`polara_tpu_torch.ops.factorize.mf_train`).  Known users
score through the fused kernel (``"item_panel"``).
"""
from __future__ import annotations

from typing import Optional

import torch

from polara_tpu_torch.models.base import EmbeddingsMixin, RecommenderModel
from polara_tpu_torch.ops.factorize import mf_train
from polara_tpu_torch.ops.scoring import TestChunk
from polara_tpu_torch.runtime.timing import track_time


class ProbabilisticMF(EmbeddingsMixin, RecommenderModel):
    def __init__(self, *args, **kwargs):
        self.seed = kwargs.pop("seed", None)
        super().__init__(*args, **kwargs)
        self.method = "PMF"
        self.learn_rate = 0.005
        self.sigma = 1.0
        self.num_epochs = 25
        self.rank = 10
        self.tolerance = 1e-4
        self.batch_size = 8192
        self.optimizer = "sgd"
        self.factors: dict = {}
        self.rmse_history: Optional[list] = None
        self.show_rmse = False
        self.iterations_time: Optional[list] = None

    def build(self, *args, **kwargs):
        coo = self.get_training_matrix()
        self.rmse_history = []
        self.iterations_time = []
        with track_time(self.training_time, verbose=self.verbose,
                        model=self.method):
            result = mf_train(
                coo.rows, coo.cols, coo.vals, coo.shape, self.rank,
                lrate=self.learn_rate,
                lambd=0.5 * self.sigma ** 2,
                num_epochs=self.num_epochs, tol=self.tolerance,
                batch_size=self.batch_size, optimizer=self.optimizer,
                generalized=True, seed=self.seed,
                dtype=self.compute_dtype, verbose=self.show_rmse,
                iter_errors=self.rmse_history,
                iter_time=self.iterations_time, device=self.device,
                **kwargs)
        self.factors[self.data.fields.userid] = result.p
        self.factors[self.data.fields.itemid] = result.q

    def score_params(self) -> dict:
        return {"user_factors": self.factors[self.data.fields.userid],
                "item_factors": self.factors[self.data.fields.itemid],
                "item_panel": self.factors[self.data.fields.itemid]}

    @staticmethod
    def proj_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        """Known-user panel: factor lookup by absolute test-user id
        (reference ``models.py:779-787``)."""
        return params["user_factors"][params["test_users"][chunk.users]]

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        return ProbabilisticMF.proj_chunk(params, chunk) \
            @ params["item_factors"].T

    def get_recommendations(self):
        if self.data.warm_start:
            raise NotImplementedError(
                "PMF has no folding-in for unseen users")
        return super().get_recommendations()
