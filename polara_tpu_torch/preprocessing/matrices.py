"""Stateless sparse-matrix-level preprocessing.

Host copy of :mod:`polara_tpu.preprocessing.matrices` (reference
``polara/preprocessing/matrices.py:9-93``): holdout splitting and
unseen-item sampling directly on a CSR ratings matrix, plus the EigenRec
popularity rescaling.  The samplers draw from ``numpy.random.RandomState``
exactly as the JAX package does, so a seed gives the same arrays in both;
the rescaling also accepts the port's device
:class:`~polara_tpu_torch.ops.sparse.CooMatrix`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from polara_tpu_torch.runtime.rng import check_random_state


def split_holdout(matrix, sample_max_rated: bool = True,
                  random_state=None) -> np.ndarray:
    """Pick one holdout item per row of a CSR matrix.

    With ``sample_max_rated`` the item is drawn uniformly among the row's
    top-rated entries, otherwise among all nonzeros (reference
    ``matrices.py:9-29``).  Vectorized: a random tie-break key per nonzero
    and a segment-argmax over rows replace the per-user loop.
    """
    matrix = matrix.tocsr()
    indptr, indices, data = matrix.indptr, matrix.indices, matrix.data
    n_users = matrix.shape[0]
    if np.any(np.diff(indptr) == 0):
        raise ValueError("every row must contain at least one item")

    random_state = check_random_state(random_state)
    tiebreak = random_state.rand(len(indices))
    if sample_max_rated:
        # key = (rating, random): max rating first, random among ties
        order = np.lexsort((tiebreak, data))
    else:
        order = np.argsort(tiebreak, kind="stable")
    rows = np.repeat(np.arange(n_users), np.diff(indptr))
    # last occurrence per row in sorted order wins
    winner = np.zeros(n_users, dtype=np.intp)
    winner[rows[order]] = order
    return indices[winner]


def mask_holdout(matrix, holdout_items: np.ndarray, copy: bool = True):
    """Zero out one holdout item per row (reference ``matrices.py:32-40``)."""
    masked = matrix.copy() if copy else matrix
    masked[np.arange(len(holdout_items)), holdout_items] = 0
    masked.eliminate_zeros()
    return masked


def sample_unseen(pool_size: int, sample_size: int, exclude,
                  random_state=None) -> np.ndarray:
    """Sample from ``range(pool_size)`` excluding given ids via the
    argpartition trick (reference ``matrices.py:63-70``)."""
    assert (pool_size - len(exclude)) >= sample_size
    random_state = check_random_state(random_state)
    src = random_state.rand(pool_size)
    np.put(src, exclude, -1)  # excluded ids can never reach the top
    return np.argpartition(src, -sample_size)[-sample_size:]


def sample_unseen_interactions(observations, holdout_items: np.ndarray,
                               size: int = 999, random_state=None,
                               chunk_rows: int = 4096) -> np.ndarray:
    """Sample ``size`` unseen items per user of a CSR observations matrix,
    also excluding the (single) holdout item per user (reference
    ``matrices.py:43-60``).  Processes users in row chunks with a dense
    random block + argpartition instead of a per-user loop.
    """
    observations = observations.tocsr()
    n_users, n_items = observations.shape
    indptr, indices = observations.indptr, observations.indices
    assert n_items - (np.diff(indptr).max() + 1) >= size

    random_state = check_random_state(random_state)
    sample = np.zeros((n_users, size), dtype=indices.dtype)
    for lo in range(0, n_users, chunk_rows):
        hi = min(lo + chunk_rows, n_users)
        block = random_state.rand(hi - lo, n_items)
        rows = np.repeat(np.arange(hi - lo), np.diff(indptr[lo:hi + 1]))
        block[rows, indices[indptr[lo]:indptr[hi]]] = -1
        block[np.arange(hi - lo), holdout_items[lo:hi]] = -1
        sample[lo:hi] = np.argpartition(
            block, -size, axis=1)[:, -size:].astype(indices.dtype)
    return sample


def rescale_matrix(matrix, scaling: float, axis: int, binary: bool = True,
                   return_scaling_values: bool = False):
    """EigenRec scaling: multiply rows (axis=1) or columns (axis=0) by
    ``norm^(scaling-1)`` where the norm is Euclidean (or sqrt-nnz when
    ``binary``); reference ``matrices.py:73-93``.

    Accepts a scipy sparse matrix or the port's device
    :class:`~polara_tpu_torch.ops.sparse.CooMatrix` (the latter scales on
    its device through :func:`~polara_tpu_torch.models.svd.rescale_coo`).
    """
    from polara_tpu_torch.ops.sparse import CooMatrix

    if isinstance(matrix, CooMatrix):
        from polara_tpu_torch.models.svd import rescale_coo
        if return_scaling_values:
            raise NotImplementedError(
                "return_scaling_values requires a host matrix")
        return rescale_coo(matrix, scaling, axis)

    from scipy.sparse import diags
    from scipy.sparse.linalg import norm as spnorm

    if scaling == 1 and not return_scaling_values:
        return matrix

    if binary:
        norm = np.sqrt(matrix.getnnz(axis=axis)).astype(np.float64)
    else:
        norm = spnorm(matrix, axis=axis, ord=2)
    # zero-norm rows/cols scale by 1 (no stored entries to rescale anyway;
    # np.power(where=...) without out= would leave garbage there)
    scaling_values = np.power(norm, scaling - 1, where=norm != 0,
                              out=np.ones_like(norm))

    scaling_matrix = diags(scaling_values)
    if axis == 0:  # scale columns
        result = matrix.dot(scaling_matrix)
    else:          # scale rows
        result = scaling_matrix.dot(matrix)

    if return_scaling_values:
        return result, scaling_values
    return result
