"""Device-resident representations of the interaction matrix.

Main-path subset of :mod:`polara_tpu.ops.sparse`: the dense block (the
default at MovieLens scale — ML-10M dense f32 is ~2.9 GB), its bf16 copy
for the power passes, and a row-sorted COO matrix whose products run as
gather -> multiply -> ``index_add_``.  Both implement the same
:class:`MatmulOperator` protocol consumed by the randomized SVD.  The
dense operators also take a row-sharded block
(:class:`~polara_tpu_torch.runtime.mesh.ShardedRows`): ``mm`` runs one
local product per shard and returns a sharded panel, ``rmm`` sums the
shards' partials with ``psum``, so the only cross-shard traffic is the
(n x b) ``rmm`` partials (and the b x b Grams of CholeskyQR2).  The
streaming (chunked, tiled, split-head) operators are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.mesh import ShardedRows, psum

Device = Union[str, torch.device, None]


@dataclasses.dataclass
class MatmulOperator:
    """A linear operator defined by blocked products ``A @ X`` / ``A.T @ X``
    (the role of ``scipy.sparse.linalg.LinearOperator``, generalized to
    k-wide panels).  ``mm_fn``/``rmm_fn`` take ``(operands, x, out_dim)``.
    """
    shape: Tuple[int, int]
    mm_fn: Callable
    rmm_fn: Callable
    operands: Tuple = ()
    dtype: torch.dtype = torch.float32

    def mm(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm_fn(self.operands, x, self.shape[0])

    def rmm(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmm_fn(self.operands, x, self.shape[1])


def _dense_mm(operands, x, out_dim):
    return operands[0] @ x


def _dense_rmm(operands, x, out_dim):
    return operands[0].T @ x


def _coo_mm(operands, x, out_dim):
    rows, cols, vals = operands
    out = torch.zeros((out_dim, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, vals[:, None].to(x.dtype) * x[cols])


def _coo_rmm(operands, x, out_dim):
    rows, cols, vals = operands
    out = torch.zeros((out_dim, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, cols, vals[:, None].to(x.dtype) * x[rows])


def _sharded_mm(operands, x, out_dim):
    (m,) = operands
    return m.map(lambda block: block @ x.to(block.device))


def _sharded_rmm(operands, x, out_dim):
    (m,) = operands
    return psum([block.T @ part for block, part in zip(m.blocks, x.blocks)],
                m.device)


def dense_operator(matrix: Union[torch.Tensor, ShardedRows]
                   ) -> MatmulOperator:
    """The dense block as an operator; a :class:`ShardedRows` block gives
    the sharded products (``mm`` -> sharded panel, ``rmm`` of a sharded
    panel -> its ``psum``) over the padded shape."""
    sharded = isinstance(matrix, ShardedRows)
    return MatmulOperator(shape=tuple(matrix.shape),
                          mm_fn=_sharded_mm if sharded else _dense_mm,
                          rmm_fn=_sharded_rmm if sharded else _dense_rmm,
                          operands=(matrix,), dtype=matrix.dtype)


def _dense_lowp_mm(operands, x, out_dim):
    (m,) = operands
    return (m @ x.to(m.dtype)).to(x.dtype)


def _dense_lowp_rmm(operands, x, out_dim):
    (m,) = operands
    return (m.T @ x.to(m.dtype)).to(x.dtype)


def _sharded_lowp_mm(operands, x, out_dim):
    (m,) = operands
    return m.map(lambda block: (block @ x.to(block.device, block.dtype)
                                ).to(x.dtype))


def _sharded_lowp_rmm(operands, x, out_dim):
    (m,) = operands
    return psum([(block.T @ part.to(block.dtype)).to(part.dtype)
                 for block, part in zip(m.blocks, x.blocks)], m.device)


def dense_power_operator(matrix: Union[torch.Tensor, ShardedRows],
                         dtype: torch.dtype = torch.bfloat16
                         ) -> MatmulOperator:
    """Low-precision operator for the randomized SVD's power passes.

    Stores the matrix in ``dtype`` — halving the memory traffic of the
    bandwidth-bound products — while panels stay in the caller's
    precision: each panel is cast down for the product and the result
    cast back up.  Pass as ``randomized_svd(..., power_operator=...)``
    beside the full-precision operator, which the refinement steps and
    the final Rayleigh–Ritz projection read.  A :class:`ShardedRows`
    block gives a sharded copy (each shard casts its own block; the
    partials of ``rmm`` are summed in the panel's precision).
    """
    if isinstance(matrix, ShardedRows):
        return MatmulOperator(shape=tuple(matrix.shape),
                              mm_fn=_sharded_lowp_mm,
                              rmm_fn=_sharded_lowp_rmm,
                              operands=(matrix.map(lambda b: b.to(dtype)),),
                              dtype=matrix.dtype)
    lo = matrix.to(dtype)
    return MatmulOperator(shape=tuple(matrix.shape), mm_fn=_dense_lowp_mm,
                          rmm_fn=_dense_lowp_rmm, operands=(lo,),
                          dtype=matrix.dtype)


@dataclasses.dataclass
class CooMatrix:
    """Row-sorted COO sparse matrix on a device (int64 indices, the index
    type ``index_add_`` and advanced indexing take)."""
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]

    @classmethod
    def from_numpy(cls, rows: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray, shape: Tuple[int, int],
                   dtype: torch.dtype = torch.float32,
                   device: Device = None) -> "CooMatrix":
        order = np.argsort(rows, kind="stable")
        device = resolve_device(device, "CooMatrix.from_numpy")
        return cls(torch.as_tensor(np.asarray(rows)[order],
                                   dtype=torch.int64).to(device),
                   torch.as_tensor(np.asarray(cols)[order],
                                   dtype=torch.int64).to(device),
                   torch.as_tensor(np.asarray(vals)[order]).to(
                       device=device, dtype=dtype),
                   tuple(int(s) for s in shape))

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype,
                          device=self.device)
        return out.index_put_((self.rows, self.cols), self.vals,
                              accumulate=True)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` via gather + ``index_add_`` over rows."""
        return _coo_mm((self.rows, self.cols, self.vals), x, self.shape[0])

    def rmatmul(self, x: torch.Tensor) -> torch.Tensor:
        """``A.T @ x`` via gather + ``index_add_`` over columns."""
        return _coo_rmm((self.rows, self.cols, self.vals), x, self.shape[1])

    def operator(self) -> MatmulOperator:
        return MatmulOperator(shape=self.shape, mm_fn=_coo_mm,
                              rmm_fn=_coo_rmm,
                              operands=(self.rows, self.cols, self.vals),
                              dtype=self.vals.dtype)

    def row_nnz(self) -> torch.Tensor:
        return torch.bincount(self.rows, minlength=self.shape[0]).to(
            self.vals.dtype)

    def col_nnz(self) -> torch.Tensor:
        return torch.bincount(self.cols, minlength=self.shape[1]).to(
            self.vals.dtype)


def coo_from_arrays(idx: np.ndarray, val: np.ndarray,
                    shape: Tuple[int, ...],
                    dtype: torch.dtype = torch.float32,
                    device: Device = None) -> CooMatrix:
    """Build from the data model's ``to_coo`` output ((nnz, 2) index)."""
    return CooMatrix.from_numpy(idx[:, 0], idx[:, 1], val, shape[:2], dtype,
                                resolve_device(device, "coo_from_arrays"))


def dense_from_coo(idx: np.ndarray, val: np.ndarray,
                   shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.float32,
                   device: Device = None) -> torch.Tensor:
    """Dense block from COO: numpy ``(nnz, d)`` index arrays accumulate on
    the host in f64 (like the JAX package) and move over in one copy;
    tensors accumulate on ``device``."""
    shape = tuple(int(s) for s in shape)
    device = resolve_device(device, "dense_from_coo")
    if isinstance(idx, np.ndarray) and isinstance(val, np.ndarray):
        flat = np.ravel_multi_index(
            tuple(idx[:, d] for d in range(idx.shape[1])), shape)
        out = np.bincount(flat, weights=val, minlength=int(np.prod(shape)))
        return torch.as_tensor(out.reshape(shape)).to(device=device,
                                                      dtype=dtype)
    idx = torch.as_tensor(idx, device=device).long()
    out = torch.zeros(shape, dtype=dtype, device=device)
    return out.index_put_(tuple(idx[:, d] for d in range(idx.shape[1])),
                          torch.as_tensor(val, device=device).to(dtype),
                          accumulate=True)
