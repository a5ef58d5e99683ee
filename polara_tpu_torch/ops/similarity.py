"""Similarity kernels over feature matrices.

Counterpart of :mod:`polara_tpu.ops.similarity` (reference
``polara/lib/similarity.py:24-235``): the similarity of an n-entity
catalog is an (n, n) dense block from matrix products.

* cosine — row-normalize then one Gram product;
* jaccard — binary Gram (intersections) + nnz counts;
* weighted jaccard — ``min(a,b)+max(a,b) = a+b`` turns the reference's
  O(n^2 f) loop into ``(f_i+f_j-L1)/(f_i+f_j+L1)`` over one L1-distance
  matrix, computed in row and feature blocks so the (n, n, d)
  intermediate never exists;
* tf-idf — idf reweighting then cosine.

Inputs may be scipy.sparse matrices, arrays or tensors; outputs are dense
tensors.  A tensor input stays on its device unless ``device`` is given;
other inputs go to ``device`` (default: the card; without one, name the
CPU).
"""
from __future__ import annotations

import sys
from typing import Union

import numpy as np
import torch

from polara_tpu_torch.runtime.device import resolve_device

Device = Union[str, torch.device, None]


def _as_dense(f, device: Device, entry_point: str) -> torch.Tensor:
    if isinstance(f, torch.Tensor):
        return f if device is None else f.to(torch.device(device))
    sparse = sys.modules.get("scipy.sparse")   # loaded if f can be one
    if sparse is not None and sparse.issparse(f):
        f = f.toarray()
    return torch.as_tensor(np.asarray(f)).to(
        resolve_device(device, entry_point))


def safe_inverse_root(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d > 0, torch.rsqrt(torch.clamp(d, min=1e-30)), 0.0)


def normalize_features(f, device: Device = None) -> torch.Tensor:
    """Row-wise L2 normalization (zero rows stay zero)."""
    f = _as_dense(f, device, "normalize_features")
    return f * safe_inverse_root((f * f).sum(1))[:, None]


def normalize_binary_features(f, device: Device = None) -> torch.Tensor:
    f = _as_dense(f, device, "normalize_binary_features")
    nnz = (f != 0).sum(1).to(f.dtype)
    return f * safe_inverse_root(nnz)[:, None]


def tfidf_transform(f, device: Device = None) -> torch.Tensor:
    f = _as_dense(f, device, "tfidf_transform")
    binary = (f != 0).to(f.dtype)
    df = 1.0 + binary.sum(0)
    idf = torch.log((1.0 + f.shape[0]) / df)
    return binary * idf[None, :]


def _fill_diag(s: torch.Tensor, value: float = 1.0) -> torch.Tensor:
    eye = torch.eye(s.shape[0], dtype=torch.bool, device=s.device)
    return s.masked_fill(eye, value)


def cosine_similarity(f, fill_diagonal: bool = True,
                      assume_binary: bool = False,
                      device: Device = None) -> torch.Tensor:
    normalize = (normalize_binary_features if assume_binary
                 else normalize_features)
    fn = normalize(_as_dense(f, device, "cosine_similarity"))
    s = fn @ fn.T
    return _fill_diag(s) if fill_diagonal else s


def cosine_tfidf_similarity(f, fill_diagonal: bool = True,
                            device: Device = None) -> torch.Tensor:
    f = _as_dense(f, device, "cosine_tfidf_similarity")
    return cosine_similarity(tfidf_transform(f),
                             fill_diagonal=fill_diagonal)


def jaccard_similarity(f, fill_diagonal: bool = True,
                       device: Device = None) -> torch.Tensor:
    f = (_as_dense(f, device, "jaccard_similarity") != 0).to(torch.float32)
    nf = f.sum(1)
    inter = f @ f.T
    union = nf[:, None] + nf[None, :] - inter
    s = torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                    0.0)
    return _fill_diag(s) if fill_diagonal else s


def _l1_distance_matrix(f: torch.Tensor, block: int = 64,
                        feature_block: int = 256) -> torch.Tensor:
    """Pairwise L1 distances with both the row axis and the feature axis
    blocked: the broadcast ``|rows - all|`` is at most
    (block, n, feature_block), whatever the catalog and feature sizes."""
    n, n_feat = f.shape
    out = torch.empty((n, n), dtype=f.dtype, device=f.device)
    for lo in range(0, n, block):
        rows = f[lo:lo + block]
        acc = torch.zeros((rows.shape[0], n), dtype=f.dtype,
                          device=f.device)
        for j in range(0, n_feat, feature_block):
            rc = rows[:, j:j + feature_block]
            fc = f[:, j:j + feature_block]
            acc += (rc[:, None, :] - fc[None, :, :]).abs().sum(-1)
        out[lo:lo + block] = acc
    return out


def jaccard_similarity_weighted(f, fill_diagonal: bool = True,
                                device: Device = None) -> torch.Tensor:
    f = _as_dense(f, device, "jaccard_similarity_weighted").to(
        torch.float32)
    if bool((f < 0).any()):
        raise ValueError("weighted jaccard requires non-negative features")
    sums = f.sum(1)
    fplus = sums[:, None] + sums[None, :]
    l1 = _l1_distance_matrix(f)
    denom = fplus + l1
    s = torch.where(denom > 0,
                    (fplus - l1) / torch.where(denom > 0, denom, 1.0), 0.0)
    return _fill_diag(s) if fill_diagonal else s


# the reference's dense variant shares this closed form
jaccard_similarity_weighted_dense = jaccard_similarity_weighted


def similarity_function(kind: str):
    table = {
        "jaccard": jaccard_similarity,
        "cosine": cosine_similarity,
        "tfidf-cosine": cosine_tfidf_similarity,
        "jaccard-weighted": jaccard_similarity_weighted,
    }
    try:
        return table[kind.lower()]
    except KeyError:
        raise ValueError(f"Unknown similarity type {kind!r}; expected one "
                         f"of {sorted(table)}") from None
