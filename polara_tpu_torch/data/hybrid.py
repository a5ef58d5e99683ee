"""Side-information data model: entity similarity matrices.

Counterpart of :mod:`polara_tpu.data.hybrid` (reference
``polara/recommender/hybrid/data.py``): the data model carries user/item
relation (similarity) matrices supplied in an external id space, lazily
reindexes them to the internal contiguous ids after every split, and
invalidates the cache on training-data changes.

The data model is host-side, so a relations matrix stays where it was
given: numpy arrays and scipy.sparse matrices become dense CPU tensors, a
tensor keeps its device (a similarity drawn on the card never crosses to
the host), and the reindexing (``index_select`` of rows and columns) runs
on that device.  Models move the reindexed matrix to their own device
(:class:`polara_tpu_torch.models.hybrid.DeviceRelationsMixin`).
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import pandas as pd
import torch

from polara_tpu_torch.data.dataset import RecommenderData


def _as_matrix(matrix) -> torch.Tensor:
    """A dense tensor: tensors as they are, everything else on the CPU."""
    if isinstance(matrix, torch.Tensor):
        return matrix
    sparse = sys.modules.get("scipy.sparse")   # loaded if matrix can be one
    if sparse is not None and sparse.issparse(matrix):
        matrix = matrix.toarray()
    return torch.as_tensor(np.asarray(matrix))


class SideRelationsMixin:
    def __init__(self, *args, relations_matrices: Dict,
                 relations_indices: Dict, **kwargs):
        super().__init__(*args, **kwargs)
        entities = [self.fields.userid, self.fields.itemid]
        self._rel_idx = {
            entity: (pd.Series(index=idx, data=np.arange(len(idx)))
                     if idx is not None else None)
            for entity, idx in relations_indices.items()
            if entity in entities}
        self._rel_mat = {
            entity: _as_matrix(matrix) if matrix is not None else None
            for entity, matrix in relations_matrices.items()
            if entity in entities}
        self._relations = dict.fromkeys(entities)
        self.subscribe(self.on_change_event, self._clean_relations)

    def _clean_relations(self):
        self._relations = dict.fromkeys(self._relations.keys())

    @property
    def item_relations(self):
        return self.get_relations_matrix(self.fields.itemid)

    @property
    def user_relations(self):
        return self.get_relations_matrix(self.fields.userid)

    def get_relations_matrix(self, entity: str):
        if self._relations.get(entity) is None:
            self._update_relations(entity)
        return self._relations[entity]

    def _relations_positions(self, entity: str, old_ids) -> torch.Tensor:
        """Rows of ``entity``'s relations matrix for external ids
        ``old_ids``, as an index tensor on the matrix's device."""
        positions = pd.Series(old_ids).map(self._rel_idx[entity]).values
        if pd.isnull(positions).any():
            raise KeyError(f"some {entity} ids are missing from the "
                           "relations index")
        return torch.as_tensor(positions.astype(np.int64),
                               device=self._rel_mat[entity].device)

    def _update_relations(self, entity: str) -> None:
        rel_mat = self._rel_mat.get(entity)
        if rel_mat is None:
            self._relations[entity] = None
            return
        if self.verbose:
            print(f"Updating {entity} relations matrix")
        entity_idx = self.get_entity_index(entity)["old"]
        positions = self._relations_positions(entity, entity_idx.values)
        self._relations[entity] = rel_mat.index_select(
            0, positions).index_select(1, positions)


class IdentityDiagonalMixin:
    """Force a unit diagonal on every relations matrix
    (reference ``hybrid/data.py:58-66``)."""

    def _update_relations(self, *args, **kwargs):
        super()._update_relations(*args, **kwargs)
        for entity, matrix in self._relations.items():
            if matrix is not None:
                self._relations[entity] = matrix.fill_diagonal_(1)


class SimilarityDataModel(IdentityDiagonalMixin, SideRelationsMixin,
                          RecommenderData):
    pass
