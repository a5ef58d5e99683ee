"""PureSVD on one device.

Counterpart of :class:`polara_tpu.models.svd.SVDModel` (reference
``polara/recommender/models.py:800-898``): randomized subspace iteration
(:mod:`polara_tpu_torch.ops.rsvd`) over the dense training block (or its
COO operator past the memory budget), and scoring as ``R_test · V · Vᵀ``
with ``proj = R_test · V`` gathered per chunk through ``index_add_``.
ScaledSVD, the Krylov solver and the streaming tiers are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from polara_tpu_torch import config as defaults
from polara_tpu_torch.models.base import RecommenderModel
from polara_tpu_torch.ops.rsvd import randomized_svd
from polara_tpu_torch.ops.scoring import TestChunk
from polara_tpu_torch.ops.sparse import (MatmulOperator, dense_operator,
                                         dense_power_operator)
from polara_tpu_torch.runtime.timing import track_time


class SVDModel(RecommenderModel):
    """PureSVD (Cremonesi et al.): ranks items by projection onto the
    dominant right-singular subspace of the rating matrix."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rank = defaults.get_default("svd_rank")
        self.method = "PureSVD"
        self.factors: dict = {}
        # accuracy knobs of the randomized solver (JAX package defaults)
        self.svd_tol: Optional[float] = 1e-9
        self.svd_iters = 8
        self.svd_oversample: Optional[int] = None
        self.seed: Optional[int] = 0
        # optional low-precision dtype (e.g. torch.bfloat16) for the
        # bandwidth-bound power iterations; the Rayleigh-Ritz projection
        # stays full-precision (see ops.sparse.dense_power_operator)
        self.svd_power_dtype: Optional[torch.dtype] = None

    @property
    def rank(self) -> int:
        return self._rank

    @rank.setter
    def rank(self, new_value: int):
        if new_value != self._rank:
            self._rank = new_value
            self._check_reduced_rank(new_value)
            self._recommendations = None

    def _check_reduced_rank(self, rank: int) -> None:
        """Truncate cached factors instead of recomputing when the rank is
        lowered (reference ``models.py:819-832``)."""
        for entity, factor in self.factors.items():
            if factor is None:
                continue
            if factor.shape[-1] < rank:
                self._is_ready = False
                self.factors = dict.fromkeys(self.factors.keys())
                break
            self.factors = dict(**self.factors)
            self.factors[entity] = factor[..., :rank]

    def build(self, operator: Optional[MatmulOperator] = None,
              return_factors: str = "vh"):
        power_op = None
        if operator is not None:
            svd_matrix = operator
        else:
            matrix = self.get_training_matrix()
            budget = defaults.get_default("hbm_score_budget_gb") * 2 ** 30
            n_rows, n_cols = matrix.shape
            itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
            if n_rows * n_cols * itemsize <= budget:
                # the dense block is shared with every model on this data
                dense = self.get_training_matrix(dense=True)
                svd_matrix = dense_operator(dense)
                if self.svd_power_dtype is not None:
                    cache = self.data.__dict__.setdefault(
                        "_device_matrix_cache", {})
                    key = ("svd_power", self.svd_power_dtype, self.device)
                    power_op = cache.get(key)
                    if power_op is None:
                        power_op = dense_power_operator(
                            dense, self.svd_power_dtype)
                        cache[key] = power_op
            else:
                svd_matrix = matrix.operator()

        with track_time(self.training_time, verbose=self.verbose,
                        model=self.method):
            result = randomized_svd(
                svd_matrix, self.rank, oversample=self.svd_oversample,
                n_iter=self.svd_iters, tol=self.svd_tol, seed=self.seed,
                power_operator=power_op)
        self._store_factors(result, return_factors)

    def _store_factors(self, result, return_factors: str) -> None:
        userid, itemid, _ = self.data.fields
        self.factors[userid] = result.u if "u" in return_factors else None
        self.factors[itemid] = result.v
        self.factors["singular_values"] = result.s

    def score_params(self) -> dict:
        v = self.factors[self.data.fields.itemid]
        return {"item_factors": v, "item_panel": v}

    @staticmethod
    def proj_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        """User-side panel ``R_chunk @ V`` without materializing R_chunk
        (feeds both the unfused path and the fused kernel)."""
        v = params["item_factors"]
        contrib = chunk.vals[:, None].to(v.dtype) * v[chunk.cols]
        contrib = torch.where(chunk.valid[:, None], contrib, 0.0)
        out = torch.zeros((chunk.users.shape[0], v.shape[1]), dtype=v.dtype,
                          device=v.device)
        return out.index_add_(0, chunk.rows, contrib)

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        return SVDModel.proj_chunk(params, chunk) @ params["item_panel"].T
