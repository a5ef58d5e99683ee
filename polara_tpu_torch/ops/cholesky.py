"""Dense Cholesky factors for similarity-regularized models.

Counterpart of :mod:`polara_tpu.ops.cholesky` (the reference's CHOLMOD
wrapper, ``polara/lib/cholesky.py`` + ``hybrid/models.py:228-332``): the
similarity matrix of an item catalog is one dense block on the device,
factorized as ``A + beta I = L Lᵀ`` exactly (CHOLMOD's ``beta``
convention), with no fill-reducing permutation.

:func:`hybrid_operator` is the implicit ``L_uᵀ R L_i`` operator of
HybridSVD.  Its sparse tier runs the ratings products as sorted segment
sums (:func:`~polara_tpu_torch.ops.sparse.sorted_rows_matmul`), so two
calls give the same bits on the card; given the dense ratings block
(the model's, when it fits its memory budget) the products are dense.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from polara_tpu_torch.ops.sparse import (CooMatrix, MatmulOperator,
                                         sorted_rows_matmul)


def _factorize(matrix: torch.Tensor, beta: float) -> torch.Tensor:
    """``cholesky(matrix + beta I)``; a matrix that is not positive definite
    raises the JAX package's ``ValueError`` (one host sync for ``info``)."""
    a = matrix.clone()
    a.diagonal().add_(beta)
    factor, info = torch.linalg.cholesky_ex(a)
    del a
    if int(info) != 0:
        raise ValueError(
            "Cholesky factorization failed: similarity + beta*I is "
            "not positive definite; raise features_weight")
    return factor


def _solve(a: torch.Tensor, y: torch.Tensor, upper: bool) -> torch.Tensor:
    if y.dim() == 1:
        return torch.linalg.solve_triangular(a, y[:, None], upper=upper)[:, 0]
    return torch.linalg.solve_triangular(a, y, upper=upper)


@dataclasses.dataclass
class CholeskyFactor:
    """Lower-triangular factor with the reference's access pattern:
    ``dot`` = L @ v, ``T.dot`` = Lᵀ @ v, ``solve`` = L⁻¹ @ v,
    ``T.solve`` = L⁻ᵀ @ v."""
    L: torch.Tensor
    _transposed: bool = False

    @classmethod
    def factorize(cls, matrix: torch.Tensor, beta: float = 0.0
                  ) -> "CholeskyFactor":
        return cls(L=_factorize(matrix, beta))

    @property
    def T(self) -> "CholeskyFactor":
        return CholeskyFactor(L=self.L, _transposed=True)

    def dot(self, v: torch.Tensor) -> torch.Tensor:
        if self._transposed:
            return self.L.T @ v
        return self.L @ v

    def solve(self, y: torch.Tensor) -> torch.Tensor:
        if self._transposed:
            return _solve(self.L.T, y, upper=True)
        return _solve(self.L, y, upper=False)

    def update_inplace(self, matrix: torch.Tensor, beta: float) -> None:
        """Refactorize ``matrix + beta I`` into this factor (raises, where
        the JAX package leaves NaNs, when it is not positive definite)."""
        self.L = _factorize(matrix, beta)


# --- implicit operator  L_uᵀ R L_i  for HybridSVD -------------------------
# (the reference builds the same chain as a scipy LinearOperator,
#  hybrid/models.py:368-384).  Operands: the ratings operands first (a
#  tensor: the solver reads its device), then l_user and l_item, each
#  None when absent.

def _hyb_dense_mm(operands, x, out_dim):
    dense_r, l_user, l_item = operands
    v = l_item @ x if l_item is not None else x
    y = dense_r @ v
    return l_user.T @ y if l_user is not None else y


def _hyb_dense_rmm(operands, x, out_dim):
    dense_r, l_user, l_item = operands
    v = l_user @ x if l_user is not None else x
    y = dense_r.T @ v
    return l_item.T @ y if l_item is not None else y


def _hyb_coo_mm(operands, x, out_dim):
    rows, cols, vals, lengths = operands[:4]
    l_user, l_item = operands[8:]
    v = l_item @ x if l_item is not None else x
    y = sorted_rows_matmul(rows, cols, vals, v, out_dim, lengths)
    return l_user.T @ y if l_user is not None else y


def _hyb_coo_rmm(operands, x, out_dim):
    cols_t, rows_t, vals_t, lengths_t = operands[4:8]
    l_user, l_item = operands[8:]
    v = l_user @ x if l_user is not None else x
    y = sorted_rows_matmul(cols_t, rows_t, vals_t, v, out_dim, lengths_t)
    return l_item.T @ y if l_item is not None else y


def hybrid_operator(ratings: Union[CooMatrix, torch.Tensor],
                    l_user: Optional[torch.Tensor],
                    l_item: Optional[torch.Tensor]) -> MatmulOperator:
    """Operator for ``L_uᵀ R L_i`` with either factor optional.

    ``None`` factors are absent (no identity products).  ``ratings`` is
    the dense block, whose products are dense, or the COO matrix, whose
    products are sorted segment sums over its entries (rows) and their
    column-sorted copy.  The caller picks the tier: the JAX package's
    ``dense_budget_bytes`` test is :meth:`SVDModel._fits_dense_budget`
    here."""
    if isinstance(ratings, torch.Tensor):
        return MatmulOperator(shape=tuple(ratings.shape),
                              mm_fn=_hyb_dense_mm, rmm_fn=_hyb_dense_rmm,
                              operands=(ratings, l_user, l_item),
                              dtype=ratings.dtype)
    return MatmulOperator(shape=ratings.shape, mm_fn=_hyb_coo_mm,
                          rmm_fn=_hyb_coo_rmm,
                          operands=ratings.segments() + (l_user, l_item),
                          dtype=ratings.vals.dtype)
