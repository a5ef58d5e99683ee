"""Host-side feature encoding: list-valued metadata columns -> matrices.

Copy of :mod:`polara_tpu.preprocessing.features` (reference
``polara/lib/similarity.py:238-443``).  The encoders (``feature2sparse``,
``get_features_data``, ``stack_features``) are pandas/scipy work that runs
once per dataset; the similarity functions return dense tensors computed
by :mod:`polara_tpu_torch.ops.similarity` on ``device`` (default: the
card; without one, name the CPU).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional, Tuple, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from polara_tpu_torch.ops import similarity as sim_ops
from polara_tpu_torch.runtime.device import resolve_device

Device = Union[str, torch.device, None]


def uniquify_ordered(seq):
    seen = set()
    out = []
    for x in seq:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


def build_indicator_matrix(labels: pd.Series,
                           max_items: Optional[int] = None) -> sp.csr_matrix:
    indices = [i for row in labels for i in row]
    indptr = np.r_[0, labels.apply(len).cumsum().values]
    data = np.ones(len(indices), dtype=bool)
    shape = (len(labels), max_items or (max(indices) + 1 if indices else 0))
    return sp.csr_matrix((data, indices, indptr), shape=shape)


def _rank_weights(items, ranking):
    if isinstance(ranking, str):
        kind = ranking.lower()
        if kind == "linear":
            return [1.0 / (n + 1) for n, _ in enumerate(items)]
        if kind == "exponential":
            return [math.exp(-n) for n, _ in enumerate(items)]
        raise ValueError(f"Unknown ranking scheme {ranking!r}")
    if callable(ranking):
        return [ranking(n) for n, _ in enumerate(items)]
    raise ValueError("ranking must be a scheme name or callable")


def feature2sparse(feature_data: pd.Series, ranking=None,
                   deduplicate: bool = True,
                   labels: Optional[Dict] = None
                   ) -> Tuple[sp.csr_matrix, Dict]:
    """Encode a column of item-feature lists into a one-hot (or
    rank-weighted) sparse matrix plus the feature label index."""
    if deduplicate:
        feature_data = feature_data.apply(
            uniquify_ordered if ranking else lambda x: sorted(set(x),
                                                              key=str))
    if ranking is True:
        ranking = "linear"

    if labels:
        label_index = dict(labels)
        indices, lengths, kept_rows = [], [], []
        for items in feature_data:
            known = [label_index[i] for i in items if i in label_index]
            indices.extend(known)
            lengths.append(len(known))
            kept_rows.append(known)
    else:
        label_index = {}
        indices, lengths, kept_rows = [], [], []
        for items in feature_data:
            row = [label_index.setdefault(i, len(label_index))
                   for i in items]
            indices.extend(row)
            lengths.append(len(row))
            kept_rows.append(items)
    indptr = np.r_[0, np.cumsum(lengths)]

    if ranking:
        data = [w for items, n in zip(kept_rows, lengths)
                for w in _rank_weights(range(n), ranking)]
    else:
        data = np.ones(len(indices))
    matrix = sp.csr_matrix((data, indices, indptr),
                           shape=(feature_data.shape[0], len(label_index)))
    return matrix, dict(label_index)


def get_features_data(meta_data: pd.DataFrame, ranking=None,
                      deduplicate: bool = True, labels=None):
    feature_mats, feature_lbls = OrderedDict(), OrderedDict()
    features = meta_data.columns
    ranking = ranking or {}
    if ranking is True:
        ranking = "linear"
    if isinstance(ranking, str):
        ranking = [ranking] * len(features)
    if not isinstance(ranking, dict):
        ranking = dict(zip(features, ranking))

    for feature in features:
        mat, lbl = feature2sparse(
            meta_data[feature], ranking=ranking.get(feature),
            deduplicate=deduplicate,
            labels=labels[feature] if labels else None)
        feature_mats[feature] = mat
        feature_lbls[feature] = lbl
    return feature_mats, feature_lbls


def stack_features(features: pd.DataFrame, add_identity: bool = False,
                   normalize: bool = True, dtype=None, labels=None,
                   stacked_index: bool = False, **kwargs):
    """Horizontally stack per-feature one-hot blocks (optionally with an
    identity block) and row-normalize — the LightFM/LCE feature layout
    (reference ``similarity.py:327-348``)."""
    feature_mats, feature_lbls = get_features_data(features, labels=labels,
                                                   **kwargs)
    matrices = list(feature_mats.values())
    if add_identity:
        matrices = [sp.eye(features.shape[0])] + matrices
    stacked = sp.hstack(matrices, format="csr", dtype=dtype)

    if normalize:
        norm = stacked.getnnz(axis=1).astype(np.float64)
        scaling = np.divide(1.0, norm, where=norm > 0,
                            out=np.zeros_like(norm))
        stacked = sp.diags(scaling) @ stacked

    if stacked_index:
        shift = features.shape[0] if add_identity else 0
        for feature, lbls in feature_lbls.items():
            feature_lbls[feature] = {k: v + shift for k, v in lbls.items()}
            shift += feature_mats[feature].shape[1]
    return stacked, feature_lbls


def one_hot_similarity(meta_data: pd.DataFrame, metric: str = "common",
                       assume_binary: bool = True,
                       fill_diagonal: bool = True, device: Device = None):
    """Similarity of the stacked one-hot features: shared-label counts
    scaled by their maximum (``"common"``) or cosine; a dense tensor on
    ``device`` and the label index."""
    device = resolve_device(device, "one_hot_similarity")
    features, labels = stack_features(meta_data, normalize=False)
    if metric == "common":
        s = torch.as_tensor(features.toarray()).to(device)
        s = s @ s.T
        s = s / s.abs().max()
        if fill_diagonal:
            s = sim_ops._fill_diag(s)
    elif metric in ("cosine", "salton"):
        s = sim_ops.cosine_similarity(features,
                                      assume_binary=assume_binary,
                                      fill_diagonal=fill_diagonal,
                                      device=device)
    else:
        raise ValueError(f"Unknown one-hot similarity metric {metric!r}")
    return s, labels


def get_similarity_data(meta_data: pd.DataFrame,
                        similarity_type="jaccard",
                        device: Device = None) -> Dict[str, torch.Tensor]:
    """``{feature: dense similarity tensor on device}``, one similarity
    kind per feature column (a name, a list or a dict)."""
    device = resolve_device(device, "get_similarity_data")
    features = meta_data.columns
    if isinstance(similarity_type, str):
        similarity_type = [similarity_type] * len(features)
    if not isinstance(similarity_type, dict):
        similarity_type = dict(zip(features, similarity_type))

    out = {}
    for feature in features:
        kind = similarity_type[feature]
        ranking = kind == "jaccard-weighted"
        matrix, _ = feature2sparse(meta_data[feature], ranking=ranking)
        out[feature] = sim_ops.similarity_function(kind)(matrix,
                                                         device=device)
    return out


def combine_similarity_data(meta_data: pd.DataFrame,
                            similarity_type="jaccard",
                            weights=None, device: Device = None
                            ) -> torch.Tensor:
    """Weighted sum of per-feature similarities, clipped to [.., 1] with a
    unit diagonal (reference ``similarity.py:413-443``)."""
    features = meta_data.columns
    n = len(features)
    if weights is None:
        weights = [1.0 / n] * n
    if not isinstance(weights, dict):
        weights = dict(zip(features, weights))

    sims = get_similarity_data(meta_data, similarity_type, device=device)
    combined = None
    for feature in features:
        term = weights[feature] * sims[feature]
        combined = term if combined is None else combined + term
    combined = torch.clamp(combined, max=1.0)
    return sim_ops._fill_diag(combined)
