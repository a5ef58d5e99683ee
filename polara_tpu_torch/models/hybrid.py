"""Hybrid models: side-information-aware recommenders.

Counterpart of :mod:`polara_tpu.models.hybrid` (reference
``polara/recommender/hybrid/models.py``):

* :class:`SimilarityAggregation` — score by propagating the test profile
  through the item similarity matrix (dense scores, unfused path);
* :class:`KernelizedPMF` — PMF with graph-kernel regularization (KPMF,
  Zhou et al.);
* :class:`LCEModel` — local collective embeddings (multiplicative-update
  NMF coupling item features and interactions over an item kNN graph),
  scored for known users through the fused kernel;
* :class:`HybridSVD` — PureSVD of the similarity-augmented matrix
  ``L_uᵀ R L_i`` via the implicit operator, with left/right projectors
  for scoring through the fused kernel; a dense device Cholesky replaces
  CHOLMOD (:mod:`polara_tpu_torch.ops.cholesky`).

Relations matrices come from the data model (on the device they were
given on) and move to the model's device and compute dtype once
(:class:`DeviceRelationsMixin`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from polara_tpu_torch.models.base import RecommenderModel
from polara_tpu_torch.models.mf import ProbabilisticMF
from polara_tpu_torch.models.svd import SVDModel, ScaledMatrixMixin
from polara_tpu_torch.ops.cholesky import CholeskyFactor, hybrid_operator
from polara_tpu_torch.ops.factorize import KernelOperator
from polara_tpu_torch.ops.scoring import TestChunk
from polara_tpu_torch.ops.topk import top_k_indices
from polara_tpu_torch.runtime.rng import generator_from_seed
from polara_tpu_torch.runtime.timing import track_time


class DeviceRelationsMixin:
    """The data model's relations matrices on this model's device, in its
    compute dtype: moved once (no copy when they are there already) and
    kept until the data's change event."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._device_relations: Dict = {}
        self.data.subscribe(self.data.on_change_event,
                            self._clean_device_relations)

    def _clean_device_relations(self):
        self._device_relations = {}

    def device_relations(self, entity: str) -> Optional[torch.Tensor]:
        if entity not in self._device_relations:
            matrix = self.data.get_relations_matrix(entity)
            self._device_relations[entity] = (
                None if matrix is None
                else matrix.to(device=self.device, dtype=self.compute_dtype))
        return self._device_relations[entity]


class SimilarityAggregation(DeviceRelationsMixin, RecommenderModel):
    """'SIM': score = R_test · S_item with zeroed diagonal
    (reference ``hybrid/models.py:25-44``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "SIM"
        self.implicit = False

    def build(self):
        similarity = self.device_relations(self.data.fields.itemid)
        self.item_similarity_matrix = similarity.clone().fill_diagonal_(0)

    def score_params(self) -> dict:
        return {"similarity": self.item_similarity_matrix,
                "implicit": bool(self.implicit)}

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        s = params["similarity"]
        vals = (torch.ones_like(chunk.vals) if params["implicit"]
                else chunk.vals)
        vals = torch.where(chunk.valid, vals.to(s.dtype), 0.0)
        profile = torch.zeros((chunk.users.shape[0], s.shape[0]),
                              dtype=s.dtype, device=s.device)
        profile.index_put_((chunk.rows, chunk.cols), vals, accumulate=True)
        return profile @ s


class KernelizedRecommenderMixin(DeviceRelationsMixin):
    """Graph-kernel regularization (KPMF, reference
    ``hybrid/models.py:47-105``): regularized-Laplacian ``I + gamma L`` or
    diffusion ``expm(beta L)`` kernels built from the data model's
    relations matrices (Laplacians here).  An entity without one gets
    ``sigma² I``, a dense block: keep that entity's count moderate."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.kernel_type = "reg"
        self.beta = 0.01
        self.gamma = 0.1
        entities = [self.data.fields.userid, self.data.fields.itemid]
        self.factor_sigma = dict.fromkeys(entities, 1.0)
        self._kernel_matrices: Dict = dict.fromkeys(entities)
        self.data.subscribe(self.data.on_change_event,
                            self._clean_kernel_data)

    def _clean_kernel_data(self):
        self._kernel_matrices = dict.fromkeys(self._kernel_matrices.keys())

    def _compute_kernel(self, laplacian: torch.Tensor,
                        kernel_type: Optional[str] = None) -> torch.Tensor:
        kernel_type = kernel_type or self.kernel_type
        if kernel_type == "dif":
            return torch.linalg.matrix_exp(self.beta * laplacian)
        if kernel_type == "reg":
            eye = torch.eye(laplacian.shape[0], dtype=laplacian.dtype,
                            device=laplacian.device)
            return eye + self.gamma * laplacian
        raise ValueError(f"Unknown kernel type {kernel_type!r}")

    def get_kernel_matrix(self, entity: str) -> torch.Tensor:
        if self._kernel_matrices.get(entity) is None:
            laplacian = self.device_relations(entity)
            if laplacian is None:
                sigma = self.factor_sigma[entity]
                n = self.data.get_entity_index(entity).shape[0]
                kernel = (sigma ** 2) * torch.eye(
                    n, dtype=self.compute_dtype, device=self.device)
            else:
                kernel = self._compute_kernel(laplacian)
            self._kernel_matrices[entity] = kernel.to(self.compute_dtype)
        return self._kernel_matrices[entity]

    @property
    def user_kernel_matrix(self) -> torch.Tensor:
        return self.get_kernel_matrix(self.data.fields.userid)

    @property
    def item_kernel_matrix(self) -> torch.Tensor:
        return self.get_kernel_matrix(self.data.fields.itemid)


class KernelizedPMF(KernelizedRecommenderMixin, ProbabilisticMF):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "KPMF"

    def build(self, *args, **kwargs):
        kwargs.setdefault("row_kernel",
                          KernelOperator.from_dense(self.user_kernel_matrix))
        kwargs.setdefault("col_kernel",
                          KernelOperator.from_dense(self.item_kernel_matrix))
        super().build(*args, **kwargs)


# --------------------------------------------------------------------------
# Local collective embeddings
# --------------------------------------------------------------------------

def knn_graph(features: torch.Tensor, n_neighbors: int,
              binary: bool = True) -> torch.Tensor:
    """kNN adjacency by euclidean distance (the sklearn NearestNeighbors
    graph of reference ``hybrid/models.py:172-181``), not symmetrized.
    Includes self-neighbors, matching ``kneighbors_graph(n_neighbors=1+k)``.

    Distances are ``‖a‖² − 2a·b + ‖b‖²`` clamped at 0 (exact for integer
    features) and ranked by the tie-exact top-k, so equal distances go to
    the lowest index, as ``lax.top_k`` does: binary genre vectors tie
    massively.  Adding 0 turns the negated zeros into +0, which a radix
    sort would otherwise rank apart."""
    sq = (features ** 2).sum(1)
    d2 = sq[:, None] - 2.0 * (features @ features.T) + sq[None, :]
    d2 = torch.clamp(d2, min=0.0)
    n = features.shape[0]
    idx = top_k_indices(-d2 + 0.0, min(1 + n_neighbors, n)).long()
    vals = (torch.ones(idx.shape, dtype=features.dtype,
                       device=features.device) if binary
            else torch.sqrt(d2.gather(1, idx)))
    graph = torch.zeros((n, n), dtype=features.dtype, device=features.device)
    return graph.scatter_(1, idx, vals)


def _list_cells(frame):
    """Feature cells that are not lists (missing rows) become []."""
    return frame.apply(lambda col: col.map(
        lambda v: v if isinstance(v, (list, tuple, set)) else []))


def local_collective_embeddings(xs: torch.Tensor, xu: torch.Tensor,
                                adjacency: torch.Tensor, k: int = 15,
                                alpha: float = 0.1, beta: float = 0.05,
                                lamb: float = 1.0, epsilon: float = 1e-4,
                                maxiter: int = 15,
                                seed: Optional[int] = None,
                                verbose: bool = False,
                                init: Optional[Sequence] = None,
                                history: Optional[List[float]] = None):
    """Multiplicative-update LCE (Saveski & Mantrach; reference
    ``lib/optimize.py:309-391``) on dense tensors on ``xs``'s device.

    ``init``: the start ``(w, hs, hu)`` (n × k, k × features, k × users);
    without it, uniform draws from a ``torch.Generator`` seeded by
    ``seed`` (not the JAX package's stream: start both packages from one
    draw to compare them).  ``history`` (an empty list) receives the
    objective after every update.  Returns ``(w, hu, hs)``."""
    n = xs.shape[0]
    dtype, device = xs.dtype, xs.device
    if init is None:
        gen = generator_from_seed(seed, device)
        w = torch.rand((n, k), generator=gen, dtype=dtype, device=device)
        hs = torch.rand((k, xs.shape[1]), generator=gen, dtype=dtype,
                        device=device)
        hu = torch.rand((k, xu.shape[1]), generator=gen, dtype=dtype,
                        device=device)
    else:
        w, hs, hu = (torch.as_tensor(x).to(device=device, dtype=dtype)
                     for x in init)

    degree = adjacency.sum(0)
    gamma = 1.0 - alpha
    tr_xs = (xs * xs).sum()
    tr_xu = (xu * xu).sum()

    def step(w, hs, hu):
        wtw = w.T @ w
        hs_new = hs * (alpha * (w.T @ xs)) / torch.clamp(
            alpha * (wtw @ hs) + lamb * hs, min=1e-10)
        hu_new = hu * (gamma * (w.T @ xu)) / torch.clamp(
            gamma * (wtw @ hu) + lamb * hu, min=1e-10)
        num = (alpha * (xs @ hs_new.T) + gamma * (xu @ hu_new.T)
               + beta * (adjacency @ w))
        den = (alpha * (w @ (hs_new @ hs_new.T))
               + gamma * (w @ (hu_new @ hu_new.T))
               + beta * (degree[:, None] * w) + lamb * w)
        w_new = w * num / torch.clamp(den, min=1e-10)

        wtw = w_new.T @ w_new
        t1 = alpha * (tr_xs - 2 * (hs_new * (w_new.T @ xs)).sum()
                      + (hs_new * (wtw @ hs_new)).sum())
        t2 = gamma * (tr_xu - 2 * (hu_new * (w_new.T @ xu)).sum()
                      + (hu_new * (wtw @ hu_new)).sum())
        t3 = beta * ((w_new * (degree[:, None] * w_new)).sum()
                     - (w_new * (adjacency @ w_new)).sum())
        t4 = lamb * (torch.trace(wtw) + (hs_new * hs_new).sum()
                     + (hu_new * hu_new).sum())
        return w_new, hs_new, hu_new, t1 + t2 + t3 + t4

    history = [] if history is None else history
    for it in range(maxiter + 1):
        w, hs, hu, objective = step(w, hs, hu)
        history.append(float(objective))       # one sync per update
        if verbose and it > 0:
            print(f"Iteration: {it + 1} Objective: {history[-1]} "
                  f"Delta: {abs(history[-1] - history[-2])}")
        if it > 0 and abs(history[-1] - history[-2]) < epsilon:
            break
    return w, hu, hs


class LCEModel(RecommenderModel):
    def __init__(self, *args, item_features=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._rank = 10
        self.factors: dict = {}
        self.alpha = 0.1
        self.beta = 0.05
        self.max_neighbours = 10
        self.item_features = item_features
        self.binary_features = True
        self._item_data = None
        self.item_features_labels = None
        self.seed = None
        self.show_error = False
        self.regularization = 1.0
        self.max_iterations = 15
        self.tolerance = 1e-4
        self.objective_history: List[float] = []
        self.method = "LCE"
        self.data.subscribe(self.data.on_change_event, self._clean_metadata)

    def _clean_metadata(self):
        self._item_data = None
        self.item_features_labels = None

    @property
    def rank(self):
        return self._rank

    @rank.setter
    def rank(self, new_value):
        if new_value != self._rank:
            self._rank = new_value
            self._is_ready = False
            self._recommendations = None

    @property
    def item_data(self):
        if self.item_features is None:
            return None
        if self._item_data is None:
            item_index = self.data.get_entity_index(self.data.fields.itemid)
            self._item_data = _list_cells(
                self.item_features.reindex(item_index["old"].values))
        return self._item_data

    def build(self, init: Optional[Sequence] = None):
        """``init``: an optional start ``(w, hs, hu)`` of
        :func:`local_collective_embeddings`."""
        from polara_tpu_torch.preprocessing.features import stack_features
        xs_sparse, labels = stack_features(self.item_data, normalize=False)
        xs = torch.as_tensor(xs_sparse.toarray()).to(
            device=self.device, dtype=self.compute_dtype)
        xu = self.get_training_matrix(dense=True).T  # items x users

        n_nbrs = min(self.max_neighbours, int(math.sqrt(xs.shape[0])))
        adjacency = knn_graph(xs, n_nbrs, binary=self.binary_features)

        self.objective_history = []
        with track_time(self.training_time, verbose=self.verbose,
                        model=self.method):
            w, hu, hs = local_collective_embeddings(
                xs, xu, adjacency, k=self.rank, alpha=self.alpha,
                beta=self.beta, lamb=self.regularization,
                epsilon=self.tolerance, maxiter=self.max_iterations,
                seed=self.seed, verbose=self.show_error, init=init,
                history=self.objective_history)

        userid = self.data.fields.userid
        itemid = self.data.fields.itemid
        self.factors[userid] = hu.T
        self.factors[itemid] = w
        self.factors[f"{itemid}_features"] = hs.T
        self.item_features_labels = labels

    def score_params(self) -> dict:
        return {"user_factors": self.factors[self.data.fields.userid],
                "item_factors": self.factors[self.data.fields.itemid],
                "item_panel": self.factors[self.data.fields.itemid]}

    # the factor lookup of PMF: known users through the fused kernel
    score_chunk = staticmethod(ProbabilisticMF.score_chunk)
    proj_chunk = staticmethod(ProbabilisticMF.proj_chunk)

    def get_recommendations(self):
        if self.data.warm_start:
            raise NotImplementedError("LCE has no warm-start folding-in")
        return super().get_recommendations()


# --------------------------------------------------------------------------
# HybridSVD
# --------------------------------------------------------------------------

class CholeskyFactorsMixin(DeviceRelationsMixin):
    """Per-entity Cholesky factors of ``S + beta I`` with
    ``beta = (1 - w)/w`` (reference ``hybrid/models.py:228-332``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        entities = [self.data.fields.userid, self.data.fields.itemid]
        self._cholesky: Dict = dict.fromkeys(entities)
        self._features_weight = 0.5
        self.data.subscribe(self.data.on_change_event, self._clean_cholesky)

    def _clean_cholesky(self):
        self._cholesky = dict.fromkeys(self._cholesky.keys())

    @property
    def features_weight(self):
        return self._features_weight

    @features_weight.setter
    def features_weight(self, new_value):
        if new_value != self._features_weight:
            self._features_weight = new_value
            beta = (1.0 - new_value) / new_value
            for entity, factor in self._cholesky.items():
                if factor is not None:
                    factor.update_inplace(self.device_relations(entity),
                                          beta)
            self._renew_model()

    def get_cholesky_factor(self, entity: str) -> Optional[CholeskyFactor]:
        if self._cholesky.get(entity) is None:
            similarity = self.device_relations(entity)
            if similarity is None:
                return None
            beta = (1.0 - self.features_weight) / self.features_weight
            if self.verbose:
                print(f"Performing dense Cholesky decomposition for "
                      f"{entity} similarity")
            self._cholesky[entity] = CholeskyFactor.factorize(similarity,
                                                              beta)
        return self._cholesky[entity]

    @property
    def item_cholesky_factor(self):
        return self.get_cholesky_factor(self.data.fields.itemid)

    @property
    def user_cholesky_factor(self):
        return self.get_cholesky_factor(self.data.fields.userid)

    def build_item_projector(self, v: torch.Tensor) -> None:
        cholesky_items = self.item_cholesky_factor
        if cholesky_items is None:
            return
        itemid = self.data.fields.itemid
        if self.verbose:
            print(f"Building {itemid} projector for {self.method}")
        # row-major, like every factor panel (the triangular solve returns
        # a column-major panel)
        self.factors[f"{itemid}_projector_left"] = \
            cholesky_items.T.solve(v).contiguous()
        self.factors[f"{itemid}_projector_right"] = \
            cholesky_items.dot(v).contiguous()

    def get_item_projector(self):
        itemid = self.data.fields.itemid
        return (self.factors.get(f"{itemid}_projector_left"),
                self.factors.get(f"{itemid}_projector_right"))


class HybridSVD(CholeskyFactorsMixin, SVDModel):
    """SVD of the similarity-augmented rating matrix via the implicit
    ``L_uᵀ R L_i`` operator; scoring projects test profiles through the
    right projector ``L V`` and ranks against the left one ``L⁻ᵀ V``
    (reference ``hybrid/models.py:335-394``), through the fused kernel on
    the card.  The projectors live in ``factors``, so a lower rank
    truncates them with the other factors."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "HybridSVD"

    def build(self, *args, **kwargs):
        coo = self.get_training_matrix()
        cholesky_items = self.item_cholesky_factor
        cholesky_users = self.user_cholesky_factor
        # SVDModel.build's budget test; the block is densified from the
        # COO on the device, as the JAX package's operator does.  The
        # shared dense training block (``_dense_operands``) accumulates on
        # the host in f64 for the SVD family's parity bits: at ML-10M
        # geometry on an H100 (chip_smoke.py phase 10) that made this
        # build 3.06 s against 0.42 s, and caching it saved nothing
        # measurable in the rebuild
        ratings = coo.to_dense() if self._fits_dense_budget(coo) else coo
        operator = hybrid_operator(
            ratings,
            cholesky_users.L if cholesky_users is not None else None,
            cholesky_items.L if cholesky_items is not None else None)
        super().build(*args, operator=operator, **kwargs)
        self.build_item_projector(self.factors[self.data.fields.itemid])

    def score_params(self) -> dict:
        vl, vr = self.get_item_projector()
        if vl is None:
            return super().score_params()
        return {"projector_left": vl, "projector_right": vr,
                "item_panel": vl}

    @staticmethod
    def proj_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        """``R_chunk @ projector_right`` as the sorted segment sum of
        :meth:`SVDModel.proj_chunk` (the same bits on every call)."""
        if "projector_right" not in params:
            return SVDModel.proj_chunk(params, chunk)
        return SVDModel.proj_chunk(
            {"item_factors": params["projector_right"]}, chunk)

    @staticmethod
    def score_chunk(params: dict, chunk: TestChunk) -> torch.Tensor:
        if "projector_left" not in params:
            return SVDModel.score_chunk(params, chunk)
        return HybridSVD.proj_chunk(params, chunk) \
            @ params["projector_left"].T


class ScaledHybridSVD(ScaledMatrixMixin, HybridSVD):
    pass
