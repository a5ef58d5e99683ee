"""Truncated-SVD model family on one device: PureSVD and the EigenRec-style
ScaledSVD.

Counterpart of :mod:`polara_tpu.models.svd` (reference
``polara/recommender/models.py:800-898``): randomized subspace iteration
or block Krylov (:mod:`polara_tpu_torch.ops.rsvd`), and scoring as
``R_test · V · Vᵀ`` with ``proj = R_test · V`` per chunk as a sorted
segment sum (bit-reproducible on the card).  The build's operator follows
the JAX package's routing under ``hbm_score_budget_gb``: the dense
training block when it fits; else the COO operator when its (nnz x block)
panel fits; else a streaming operator (the split head, or the tiled one
with ``streaming_split_head`` off).  Under a mesh the dense block and its
bf16 copy shard by rows over the ``users`` axis and the solve
orthogonalizes with CholeskyQR2; past the budget the events shard into
row bands (``distributed_chunked_rsvd``).
"""
from __future__ import annotations

from typing import Optional

import torch

from polara_tpu_torch import config as defaults
from polara_tpu_torch.models.base import RecommenderModel
from polara_tpu_torch.ops.rsvd import randomized_svd, randomized_svd_krylov
from polara_tpu_torch.ops.scoring import TestChunk
from polara_tpu_torch.ops.sparse import (CooMatrix, MatmulOperator,
                                         dense_operator,
                                         dense_power_operator,
                                         sorted_rows_matmul)
from polara_tpu_torch.parallel.distributed import distributed_chunked_rsvd
from polara_tpu_torch.runtime.mesh import shard_device_count, shard_rows
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
        # "subspace" (tolerance-controlled power iteration with block
        # auto-escalation, the default) or "krylov" (block-Krylov
        # Rayleigh-Ritz at depth ``svd_iters // 2``; no stopping test, so
        # ``svd_tol`` applies to the subspace path only)
        self.svd_method = "subspace"
        # optional low-precision dtype (e.g. torch.bfloat16) for the
        # bandwidth-bound power iterations; the Rayleigh-Ritz projection
        # stays full-precision (see ops.sparse.dense_power_operator)
        self.svd_power_dtype: Optional[torch.dtype] = None
        # the subspace solver's iteration record of the last build
        self.svd_info: dict = {}

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

    @staticmethod
    def _dense_budget_bytes(mesh=None) -> float:
        """``hbm_score_budget_gb`` in bytes; the budget is per device, so
        under a mesh the block shards over the distinct devices of its
        users axis."""
        budget = defaults.get_default("hbm_score_budget_gb") * 2 ** 30
        return budget * shard_device_count(mesh) if mesh is not None \
            else budget

    def _fits_dense_budget(self, matrix: CooMatrix, mesh=None) -> bool:
        """Whether the dense training block fits the memory budget."""
        n_rows, n_cols = matrix.shape
        itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
        return n_rows * n_cols * itemsize <= self._dense_budget_bytes(mesh)

    def _dense_operands(self, matrix: CooMatrix, mesh=None):
        """The dense block (and its power operator) for this model's
        scaling, cached on the data object.

        The unscaled single-device block is the plain dense training
        matrix, shared with every model on the data; any other block is
        cached under ``("svd_dense", mesh or device, signature)``, a mesh's
        row-sharded over its ``users`` axis (zero rows pad it to a multiple
        of the axis; they leave AᵀA, hence s and V, unchanged).  When this
        model's key changes, only its own previous entries (block and power
        operator) are evicted, so a sweep never accumulates ~GB blocks and
        never drops a sibling's.  (The signature is one element of the key,
        so the unscaled key prefixes no scaled one.)"""
        cache = self.data.__dict__.setdefault("_device_matrix_cache", {})
        key = ("svd_dense", self.device if mesh is None else mesh,
               self._scaling_signature())
        if key != getattr(self, "_last_dense_key", None):
            self._evict_dense_entries(cache)
            self._last_dense_key = key
        if mesh is None and self._scaling_signature() == ():
            dense = self.get_training_matrix(dense=True)
        else:
            dense = cache.get(key)
            if dense is None:
                dense = matrix.to_dense()
                if mesh is not None:
                    dense = shard_rows(dense, mesh)
                cache[key] = dense
        power_op = None
        if self.svd_power_dtype is not None:
            lo_key = key + ("power", self.svd_power_dtype)
            power_op = cache.get(lo_key)
            if power_op is None:
                power_op = cache[lo_key] = dense_power_operator(
                    dense, self.svd_power_dtype)
        return dense, power_op

    def build(self, operator: Optional[MatmulOperator] = None,
              return_factors: str = "vh"):
        mesh = self.active_mesh
        power_op = None
        if operator is not None:
            svd_matrix = operator
        else:
            matrix = self.get_training_matrix()
            itemsize = torch.empty((), dtype=self.compute_dtype).element_size()
            block = self.rank + (self.svd_oversample
                                 if self.svd_oversample is not None
                                 else max(10, self.rank))
            coo_bytes = matrix.nnz * block * itemsize
            if self._fits_dense_budget(matrix, mesh):
                dense, power_op = self._dense_operands(matrix, mesh)
                svd_matrix = dense_operator(dense)
            elif coo_bytes <= self._dense_budget_bytes(mesh):
                svd_matrix = matrix.operator()
            elif mesh is not None:
                # past the budget under a mesh: the events shard into
                # user-row bands, each streamed on its own device
                self.svd_info = {}
                with track_time(self.training_time, verbose=self.verbose,
                                model=self.method):
                    result = distributed_chunked_rsvd(
                        matrix.rows, matrix.cols, matrix.vals,
                        matrix.shape, self.rank, mesh,
                        oversample=self.svd_oversample,
                        n_iter=self.svd_iters, seed=self.seed,
                        tol=self.svd_tol,
                        split_head=defaults.get_default(
                            "streaming_split_head"),
                        head_budget_gb=defaults.get_default(
                            "streaming_head_gb"),
                        dtype=self.compute_dtype)
                self._store_factors(result, return_factors)
                return
            elif defaults.get_default("streaming_split_head"):
                # even the COO operator's (nnz x block) panel is past the
                # budget: stream the events, the Zipf head as a dense
                # block when the item margins are skewed enough to pay
                svd_matrix = matrix.split_operator(
                    head_budget_gb=defaults.get_default(
                        "streaming_head_gb"))
            else:
                svd_matrix = matrix.tiled_operator()

        # CholeskyQR2 shards cleanly (a b x b Gram psum); Householder QR
        # would gather the whole panel onto one device
        qr_method = "cholesky2" if mesh is not None else None
        self.svd_info = {}
        with track_time(self.training_time, verbose=self.verbose,
                        model=self.method):
            if self.svd_method == "krylov":
                result = randomized_svd_krylov(
                    svd_matrix, self.rank,
                    depth=max(2, self.svd_iters // 2),
                    oversample=self.svd_oversample, seed=self.seed,
                    qr_method=qr_method, power_operator=power_op)
            else:
                result = randomized_svd(
                    svd_matrix, self.rank, oversample=self.svd_oversample,
                    n_iter=self.svd_iters, tol=self.svd_tol, seed=self.seed,
                    qr_method=qr_method, power_operator=power_op,
                    info=self.svd_info)
        self._store_factors(result, return_factors)

    def _store_factors(self, result, return_factors: str) -> None:
        userid, itemid, _ = self.data.fields
        self.factors[userid] = result.u if "u" in return_factors else None
        self.factors[itemid] = result.v
        self.factors["singular_values"] = result.s

    def _scaling_signature(self) -> tuple:
        """Cache-key part of the dense training block (ScaledMatrixMixin
        adds its scaling exponents)."""
        return ()

    def _evict_dense_entries(self, cache: dict) -> None:
        """Drop this model's previously cached dense block and the power
        operator derived from it."""
        last = getattr(self, "_last_dense_key", None)
        if last is None:
            return
        for stale in [k for k in cache
                      if isinstance(k, tuple) and k[:len(last)] == last]:
            del cache[stale]

    def score_params(self) -> dict:
        v = self.factors[self.data.fields.itemid]
        return {"item_factors": v, "item_panel": v}

    @staticmethod
    def proj_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        """User-side panel ``R_chunk @ V`` without materializing R_chunk
        (feeds both the unfused path and the fused kernel), as a sorted
        segment sum over the chunk's row-sorted events: the same bits on
        every call.  Padding events (at the tail) become zero terms of
        the last row, which keeps the rows sorted."""
        v = params["item_factors"]
        n_rows = chunk.users.shape[0]
        rows = torch.where(chunk.valid, chunk.rows, n_rows - 1)
        vals = torch.where(chunk.valid, chunk.vals.to(v.dtype), 0.0)
        return sorted_rows_matmul(rows, chunk.cols, vals, v, n_rows)

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        return SVDModel.proj_chunk(params, chunk) @ params["item_panel"].T


class ScaledMatrixMixin:
    """EigenRec-style popularity rescaling of the rating matrix
    (reference ``models.py:864-895`` + ``preprocessing/matrices.py:71-93``):
    column j is scaled by ``nnz_j^((d-1)/2)`` with d = col_scaling (default
    0.4 damps popular items), rows likewise."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._col_scaling = 0.4
        self._row_scaling = 1
        self.method = f"{self.method}-s"

    @property
    def col_scaling(self):
        return self._col_scaling

    @col_scaling.setter
    def col_scaling(self, new_value):
        if new_value != self._col_scaling:
            self._col_scaling = new_value
            self._recommendations = None

    @property
    def row_scaling(self):
        return self._row_scaling

    @row_scaling.setter
    def row_scaling(self, new_value):
        if new_value != self._row_scaling:
            self._row_scaling = new_value
            self._recommendations = None

    def get_training_matrix(self, *args, **kwargs):
        matrix = super().get_training_matrix(*args, **kwargs)
        if not isinstance(matrix, CooMatrix):
            raise TypeError("scaled models need the COO training matrix")
        return rescale_coo(rescale_coo(matrix, self._row_scaling, axis=1),
                           self._col_scaling, axis=0)

    def _scaling_signature(self) -> tuple:
        return (float(self._row_scaling), float(self._col_scaling))


def rescale_coo(matrix: CooMatrix, scaling: float, axis: int) -> CooMatrix:
    """Scale rows (axis=1) or columns (axis=0) by the binary Euclidean norm
    (sqrt of the nnz count) raised to ``scaling - 1``.

    As in the JAX package's ``_scale_vals`` the norm and the exponent are
    in the values' dtype; the power itself is taken in f64 and rounded
    once, so each factor is the correctly rounded value on any device.
    XLA's f32 ``pow`` is 1 ulp off that for about 0.07% of counts (first
    at count 189 for ``scaling=0.4``), where the two packages' factors
    differ by that ulp."""
    if scaling == 1:
        return matrix
    if axis == 1:
        norms, idx = torch.sqrt(matrix.row_nnz()), matrix.rows
    else:
        norms, idx = torch.sqrt(matrix.col_nnz()), matrix.cols
    safe = torch.where(norms > 0, norms, 1.0)
    exponent = torch.tensor(float(scaling) - 1.0,
                            dtype=matrix.vals.dtype).item()
    factors = torch.pow(safe.double(), exponent).to(matrix.vals.dtype)
    return CooMatrix(matrix.rows, matrix.cols, matrix.vals * factors[idx],
                     matrix.shape)


class ScaledSVD(ScaledMatrixMixin, SVDModel):
    """PureSVD-s, a.k.a. EigenRec."""
