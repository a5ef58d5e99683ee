"""Item cold-start models: recommend users for cold items.

Counterpart of :mod:`polara_tpu.models.coldstart` (reference
``polara/recommender/coldstart/models.py:13-257``).  The scoring axis
flips — rows are cold items, candidates are (representative) users — and
every factor model folds cold items into the latent space through a
feature mapping ``W = Fᵀ·V`` and its pseudo-inverse Gram.  The score
block (cold items × candidate users) is dense on the model's device and
ranked by the tie-exact :func:`~polara_tpu_torch.ops.topk.top_k_indices`
(not the fused kernel, as in the JAX package).

Candidate-pool semantics (kept from the JAX package): scores are computed
against the representative user pool when one is configured (and against
all training users otherwise), and the returned recommendation entries
are always *internal user ids*.

Pseudo-inverses cut singular values at ``10·max(m, n)·eps·s₀``, the
default of ``jnp.linalg.pinv`` (``torch.linalg.pinv``'s own is ten times
lower): the Grams are rank-deficient by construction when the rank
exceeds the feature labels, and the cut decides which near-zero
directions survive.  Feature encoding (pandas/scipy) loads on first use.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from polara_tpu_torch.models.base import RecommenderModel
from polara_tpu_torch.models.hybrid import HybridSVD, LCEModel, _list_cells
from polara_tpu_torch.models.svd import ScaledMatrixMixin, SVDModel
from polara_tpu_torch.ops.topk import PAD_CONST, top_k_indices


def pinv(matrix: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse with ``jnp.linalg.pinv``'s cut-off."""
    rtol = 10 * max(matrix.shape[-2:]) * torch.finfo(matrix.dtype).eps
    return torch.linalg.pinv(matrix, rtol=rtol)


def _pad_user_columns(recs: np.ndarray, topk: int) -> np.ndarray:
    """Pad recommendation rows to the (n_cold, topk) contract when the
    candidate pool is smaller than topk (PAD_CONST like the top-k ops)."""
    if recs.shape[1] >= topk:
        return recs[:, :topk]
    pad = np.full((recs.shape[0], topk - recs.shape[1]), PAD_CONST,
                  dtype=recs.dtype)
    return np.concatenate([recs, pad], axis=1)


def _host_product(matrix, factors: torch.Tensor) -> torch.Tensor:
    """A host scipy matrix times device factors (as the JAX package does
    it: an f64 product on the host), back on the factors' device in
    their dtype."""
    out = matrix @ factors.detach().cpu().double().numpy()
    return torch.as_tensor(out).to(device=factors.device,
                                   dtype=factors.dtype)


class ItemColdStartEvaluationMixin:
    """Flip prediction key/target; nothing is 'seen' for a cold item
    (reference ``coldstart/models.py:13-18``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.filter_seen = False
        self._prediction_key = self.data.cold_itemid
        self._prediction_target = self.data.fields.userid


class ColdItemsScoringMixin:
    """Scoring: dense (cold items × candidate users) scores → top-k user
    ids.  Subclasses implement ``compute_cold_scores(candidates)``
    returning a device score block over the candidate columns."""

    def _candidate_users(self) -> Optional[np.ndarray]:
        repr_users = self.data.representative_users
        if repr_users is None:
            return None
        return repr_users["new"].values

    def get_recommendations(self) -> np.ndarray:
        if self.verify_integrity:
            self.verify_data_integrity()
        candidates = self._candidate_users()
        scores = self.compute_cold_scores(candidates)
        recs = top_k_indices(scores, self.topk).cpu().numpy()
        if candidates is not None:
            valid = recs >= 0
            recs = np.where(valid, candidates[np.where(valid, recs, 0)],
                            recs)
        return recs

    def _candidate_rows(self, panel: torch.Tensor, candidates
                        ) -> torch.Tensor:
        if candidates is None:
            return panel
        return panel.index_select(0, torch.as_tensor(
            candidates.astype(np.int64), device=panel.device))

    def cold_item_metadata(self):
        """Feature rows of the cold items in cold-index order."""
        cold_old = self.data.index.itemid.cold_start["old"].values
        return _list_cells(self.item_features.reindex(cold_old))

    def cold_one_hot(self):
        """The cold items' one-hot features over the training labels."""
        from polara_tpu_torch.preprocessing.features import stack_features
        one_hot, _ = stack_features(self.cold_item_metadata(),
                                    labels=self.item_features_labels,
                                    normalize=False)
        return one_hot


class RandomModelItemColdStart(ItemColdStartEvaluationMixin,
                               ColdItemsScoringMixin, RecommenderModel):
    """'RND(cs)': uniformly random users per cold item."""

    def __init__(self, *args, seed=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = seed
        self.method = "RND(cs)"

    def build(self):
        self._random_state = np.random.RandomState(self.seed)

    def get_recommendations(self):
        candidates = self._candidate_users()
        if candidates is None:
            candidates = self.data.index.userid.training["new"].values
        n_cold = self.data.index.itemid.cold_start.shape[0]
        take = min(self.topk, len(candidates))
        keys = self._random_state.rand(n_cold, len(candidates))
        top = np.argpartition(keys, take - 1, axis=1)[:, :take]
        return _pad_user_columns(candidates[top], self.topk)


class PopularityModelItemColdStart(ItemColdStartEvaluationMixin,
                                   ColdItemsScoringMixin, RecommenderModel):
    """'MP(cs)': the most active users, identically for every cold item."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "MP(cs)"

    def build(self):
        userid = self.data.fields.userid
        user_activity = self.data.training[userid].value_counts(sort=False)
        repr_users = self.data.representative_users
        if repr_users is not None:
            user_activity = user_activity.reindex(repr_users["new"].values,
                                                  fill_value=0)
        self.user_scores = user_activity.sort_values(ascending=False)

    def get_recommendations(self):
        n_cold = self.data.index.itemid.cold_start.shape[0]
        top_users = self.user_scores.index[:self.topk].values
        recs = np.broadcast_to(top_users, (n_cold, len(top_users))).copy()
        return _pad_user_columns(recs, self.topk)


class SimilarityAggregationItemColdStart(ItemColdStartEvaluationMixin,
                                         ColdItemsScoringMixin,
                                         RecommenderModel):
    """'SIM(cs)': score = S(cold, seen) · Rᵀ
    (reference ``coldstart/models.py:101-119``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "SIM(cs)"
        self.implicit = False

    def build(self):
        pass

    def compute_cold_scores(self, candidates) -> torch.Tensor:
        ratings = self.get_training_matrix(dense=True,
                                           ignore_feedback=self.implicit)
        similarity = self.data.cold_items_similarity.to(
            device=ratings.device, dtype=ratings.dtype)
        return similarity @ self._candidate_rows(ratings, candidates).T


class ItemColdStartSVDModelMixin:
    """Feature fold-in for the SVD family: map one-hot item features onto
    item factors (``W = FᵀV``), invert its Gram, and project cold feature
    rows into the latent space (reference ``coldstart/models.py:149-222``).
    Rank truncation keeps the trick compatible with cheap rank sweeps."""

    def __init__(self, *args, item_features=None, **kwargs):
        super().__init__(*args, **kwargs)
        if item_features is None:  # provided via the data model
            item_features = self.data.item_features
        assert item_features is not None
        self.item_features = item_features
        self.item_features_labels = None
        self._transform_invgram = None
        self.data.subscribe(self.data.on_change_event, self._clean_metadata)

    def _clean_metadata(self):
        self.item_features_labels = None

    @property
    def item_features_embeddings(self):
        return self.factors.get(f"{self.data.fields.itemid}_features")

    def _check_reduced_rank(self, rank):
        super()._check_reduced_rank(rank)
        mapping = self.item_features_embeddings
        if mapping is None:
            self._transform_invgram = None
        elif (self._transform_invgram is not None
              and self._transform_invgram.shape[0] != mapping.shape[1]):
            # any mismatch, not just shrinkage: a sweep can leave a low-rank
            # invgram behind and the user may then *raise* the rank back
            # within the cached factors' width
            self.update_item_features_transform()

    def encode_item_features(self):
        from polara_tpu_torch.preprocessing.features import stack_features
        training_items = self.data.index.itemid.training["old"].values
        meta = _list_cells(self.item_features.reindex(training_items))
        one_hot, self.item_features_labels = stack_features(
            meta, stacked_index=False, normalize=False)
        return one_hot

    def update_item_features_transform(self):
        mapping = self.item_features_embeddings
        self._transform_invgram = pinv(mapping.T @ mapping)

    def build(self, *args, **kwargs):
        super().build(*args, return_factors="uv", **kwargs)
        one_hot = self.encode_item_features()
        mapping = self.compute_item_features_mapping(one_hot)
        # stored in factors so rank truncation shortens it automatically
        self.factors[f"{self.data.fields.itemid}_features"] = mapping
        self.update_item_features_transform()

    def set_factors(self, factors: Dict[str, Optional[torch.Tensor]]
                    ) -> None:
        """Install trained factors, then rebuild the derived state: the
        training items' feature labels, the feature mapping if the factors
        lack it, and its inverse Gram."""
        super().set_factors(factors)
        one_hot = self.encode_item_features()
        if self.item_features_embeddings is None:
            self.factors[f"{self.data.fields.itemid}_features"] = \
                self.compute_item_features_mapping(one_hot)
        self.update_item_features_transform()

    def _map_features_to_factors(self, one_hot, factors) -> torch.Tensor:
        """host-sparse Fᵀ (n_labels × n_items) times device factors."""
        return _host_product(one_hot.T, factors)

    def compute_cold_scores(self, candidates) -> torch.Tensor:
        w = self.item_features_embeddings
        cold_factors = (_host_product(self.cold_one_hot(), w)
                        @ self._transform_invgram)
        userid = self.data.fields.userid
        u = self.factors[userid]
        s = self.factors["singular_values"]
        user_panel = self._candidate_rows(u * s[None, :], candidates)
        return cold_factors.to(user_panel.dtype) @ user_panel.T


class SVDModelItemColdStart(ItemColdStartEvaluationMixin,
                            ColdItemsScoringMixin,
                            ItemColdStartSVDModelMixin, SVDModel):
    """'PureSVD(cs)'."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "PureSVD(cs)"

    def compute_item_features_mapping(self, one_hot) -> torch.Tensor:
        item_factors = self.factors[self.data.fields.itemid]
        return self._map_features_to_factors(one_hot, item_factors)


class HybridSVDItemColdStart(ItemColdStartEvaluationMixin,
                             ColdItemsScoringMixin,
                             ItemColdStartSVDModelMixin, HybridSVD):
    """'HybridSVD(cs)': cold features map onto the right projector."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "HybridSVD(cs)"

    def compute_item_features_mapping(self, one_hot) -> torch.Tensor:
        itemid = self.data.fields.itemid
        projector = self.factors[f"{itemid}_projector_right"]
        return self._map_features_to_factors(one_hot, projector)


class ScaledSVDItemColdStart(ScaledMatrixMixin, SVDModelItemColdStart):
    pass


class ScaledHybridSVDItemColdStart(ScaledMatrixMixin, HybridSVDItemColdStart):
    pass


class LCEModelItemColdStart(ItemColdStartEvaluationMixin,
                            ColdItemsScoringMixin, LCEModel):
    """'LCE(cs)': fold cold-item features through the feature-factor Gram
    (reference ``coldstart/models.py:122-146``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.method = "LCE(cs)"
        self.item_features_invgram = None

    @property
    def item_data(self):
        """Training-item feature rows (cold items are excluded from the
        training index by construction)."""
        if self.item_features is None:
            return None
        if self._item_data is None:
            item_index = self.data.index.itemid.training
            self._item_data = _list_cells(
                self.item_features.reindex(item_index["old"].values))
        return self._item_data

    def _update_invgram(self) -> None:
        hs = self.factors[f"{self.data.fields.itemid}_features"].T  # k × f
        self.item_features_invgram = pinv(hs @ hs.T)

    def build(self, *args, **kwargs):
        super().build(*args, **kwargs)
        self._update_invgram()

    def set_factors(self, factors: Dict[str, Optional[torch.Tensor]]
                    ) -> None:
        """Install trained factors, then rebuild the training items'
        feature labels and the features' inverse Gram."""
        from polara_tpu_torch.preprocessing.features import stack_features
        super().set_factors(factors)
        _, self.item_features_labels = stack_features(self.item_data,
                                                      normalize=False)
        self._update_invgram()

    def compute_cold_scores(self, candidates) -> torch.Tensor:
        hs = self.factors[f"{self.data.fields.itemid}_features"]  # f × k
        cold_factors = torch.clamp(
            _host_product(self.cold_one_hot(), hs)
            @ self.item_features_invgram, min=0.0)
        hu = self._candidate_rows(self.factors[self.data.fields.userid],
                                  candidates)  # n_users × k
        return cold_factors.to(hu.dtype) @ hu.T
