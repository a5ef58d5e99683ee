"""Device-resident representations of the interaction matrix.

Main-path subset of :mod:`polara_tpu.ops.sparse`: the dense block (the
default at MovieLens scale — ML-10M dense f32 is ~2.9 GB), its bf16 copy
for the power passes, and a row-sorted COO matrix whose products run as
sorted segment sums (:func:`sorted_rows_matmul`: a fixed summation order,
so two calls give identical bits on the card, where ``index_add_``'s
atomics do not).  Both implement the same
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
from typing import Callable, Optional, Tuple, Union

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


def sorted_rows_matmul(rows: Optional[torch.Tensor], cols: torch.Tensor,
                       vals: torch.Tensor, x: torch.Tensor, n_rows: int,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``out[r] = Σ_{e: rows[e] = r} vals[e] · x[cols[e]]`` for entries
    sorted by row, as a sorted segment sum (``torch.segment_reduce``):
    each output element is summed over its row's entries in order by one
    thread, so the result has the same bits on every call.  On the card
    ``index_add_`` sums with atomics and a CSR ``torch.sparse.mm``
    (cuSPARSE) also changes its order between calls.  ``lengths``: the
    entries per row, if known (``rows`` is then not read)."""
    if lengths is None:
        lengths = torch.bincount(rows, minlength=n_rows)
    terms = vals[:, None].to(x.dtype) * x[cols]
    return torch.segment_reduce(terms, "sum", lengths=lengths, axis=0)


def _coo_mm(operands, x, out_dim):
    rows, cols, vals, lengths = operands[:4]
    return sorted_rows_matmul(rows, cols, vals, x, out_dim, lengths)


def _coo_rmm(operands, x, out_dim):
    rows, cols, vals, lengths = operands[4:]
    return sorted_rows_matmul(rows, cols, vals, x, out_dim, lengths)


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
    type advanced indexing takes).  Its products are sorted segment sums
    (:func:`sorted_rows_matmul`) over the entries and over a column-sorted
    copy of them, built on first use and kept."""
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

    def segments(self) -> Tuple[torch.Tensor, ...]:
        """``(rows, cols, vals, row_lengths)`` of ``A`` and the same of
        ``Aᵀ`` (the entries in a stable sort by column), built once per
        matrix: the operands of the products."""
        segs = self.__dict__.get("_segments")
        if segs is None:
            order = torch.argsort(self.cols, stable=True)
            segs = self.__dict__["_segments"] = (
                self.rows, self.cols, self.vals,
                torch.bincount(self.rows, minlength=self.shape[0]),
                self.cols[order], self.rows[order], self.vals[order],
                torch.bincount(self.cols, minlength=self.shape[1]))
        return segs

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` as a sorted segment sum over rows (bit-reproducible)."""
        return _coo_mm(self.segments(), x, self.shape[0])

    def rmatmul(self, x: torch.Tensor) -> torch.Tensor:
        """``A.T @ x`` as a sorted segment sum over columns."""
        return _coo_rmm(self.segments(), x, self.shape[1])

    def operator(self) -> MatmulOperator:
        return MatmulOperator(shape=self.shape, mm_fn=_coo_mm,
                              rmm_fn=_coo_rmm, operands=self.segments(),
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


# cells of the f64 accumulator the host path of dense_from_coo allocates at
# once: a bigger target accumulates in blocks of leading-dimension slices
DENSE_BLOCK_CELLS = 1 << 26


def dense_from_coo(idx: np.ndarray, val: np.ndarray,
                   shape: Tuple[int, ...],
                   dtype: torch.dtype = torch.float32,
                   device: Device = None) -> torch.Tensor:
    """Dense block from COO: numpy ``(nnz, d)`` index arrays accumulate on
    the host in f64 (like the JAX package) and move over in one copy;
    tensors accumulate on ``device``.

    Past ``DENSE_BLOCK_CELLS`` cells the host path accumulates one block
    of leading-dimension slices at a time into the output, so the f64
    transient stays near 512 MB instead of twice the tensor; each cell's
    sum runs over its events in the same order either way, so the result
    has the same bits."""
    shape = tuple(int(s) for s in shape)
    device = resolve_device(device, "dense_from_coo")
    if isinstance(idx, np.ndarray) and isinstance(val, np.ndarray):
        total = int(np.prod(shape))
        if total <= DENSE_BLOCK_CELLS:
            flat = np.ravel_multi_index(
                tuple(idx[:, d] for d in range(idx.shape[1])), shape)
            out = np.bincount(flat, weights=val, minlength=total)
            return torch.as_tensor(out.reshape(shape)).to(device=device,
                                                          dtype=dtype)
        out = torch.empty(shape, dtype=dtype)
        inner = total // shape[0]
        rows_per_block = max(1, DENSE_BLOCK_CELLS // inner)
        lead = idx[:, 0]
        inner_flat = (np.ravel_multi_index(
            tuple(idx[:, d] for d in range(1, idx.shape[1])), shape[1:])
            if idx.shape[1] > 1 else np.zeros(len(idx), np.int64))
        for lo in range(0, shape[0], rows_per_block):
            hi = min(lo + rows_per_block, shape[0])
            sel = (lead >= lo) & (lead < hi)
            block = np.bincount((lead[sel] - lo) * inner + inner_flat[sel],
                                weights=val[sel],
                                minlength=(hi - lo) * inner)
            out[lo:hi] = torch.from_numpy(block.reshape((hi - lo,)
                                                        + shape[1:]))
        return out.to(device)
    idx = torch.as_tensor(idx, device=device).long()
    out = torch.zeros(shape, dtype=dtype, device=device)
    return out.index_put_(tuple(idx[:, d] for d in range(idx.shape[1])),
                          torch.as_tensor(val, device=device).to(dtype),
                          accumulate=True)


def gather_padded_panels(owner: torch.Tensor, base: torch.Tensor,
                         counts: torch.Tensor, ev_start: torch.Tensor,
                         minor: torch.Tensor, vals: torch.Tensor,
                         n_tiles: int, tile: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-padded (minor, value) panels built with gathers, not scatters.

    Every entity's events (``counts[e]`` of them from ``ev_start[e]`` of
    the entity-sorted stream) fill its tiles from slot ``base[e]``; tile
    ``t`` belongs to ``owner[t]``.  The event -> slot map is strictly
    monotonic, so each slot looks up its source event: real positions
    read the stream, pad positions read event 0 with value 0 and minor
    id 0.  Used by the streaming-iALS staging
    (:func:`polara_tpu_torch.ops.implicit.stage_events_panels`)."""
    e_pad = n_tiles * tile
    ent = owner[:, None].expand(n_tiles, tile).reshape(-1)
    p = torch.arange(e_pad, device=owner.device) - base[ent]
    valid = p < counts[ent]
    src = torch.where(valid, ev_start[ent] + torch.minimum(p, counts[ent] - 1),
                      0)
    minor_p = torch.where(valid, minor.long()[src], 0)
    vals_p = torch.where(valid, vals[src], torch.zeros((), dtype=vals.dtype,
                                                       device=vals.device))
    return minor_p, vals_p
