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
(n x b) ``rmm`` partials (and the b x b Grams of CholeskyQR2).

Past the memory budget even the COO operator's (nnz x block) panel does
not fit (80 GB at Netflix geometry), so the streaming operators take its
place, each peaking at one (event_chunk x block) panel:

* :func:`chunked_coo_operator`: per chunk of major-sorted events, gather,
  scale, and a sorted segment sum over the chunk's local rows, added into
  the output in chunk order; ``rmm`` runs the same pass over a
  column-sorted copy staged once;
* :func:`tiled_coo_operator`: every entity's events pad to whole tiles
  of ``tile`` events, so a chunk reduces as a batched (1 x tile) x
  (tile x k) contraction and a sorted segment sum over tile owners;
* :func:`split_coo_operator`: the events of the P most-rated items go
  once into a dense (row blocks x P) head (int8 when lossless), multiplied
  one upcast row block at a time; the tail stays tiled.

No pass sums floats with atomics, so two calls give the same bits on the
card (fault C2's lesson).  The JAX package's wire codecs
(``_upload_event_stream``) and staging profiler are not ported: the
operators take numpy arrays or tensors and move them to ``device`` once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

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

    @property
    def device(self) -> torch.device:
        """The device of the first tensor among the operands."""
        return _first_tensor(self.operands).device


def _first_tensor(operands) -> torch.Tensor:
    stack = [operands]
    while stack:
        item = stack.pop(0)
        if isinstance(item, torch.Tensor):
            return item
        if isinstance(item, ShardedRows):
            return item.blocks[0]
        if isinstance(item, (tuple, list)):
            stack[:0] = list(item)
    raise ValueError("the operator holds no tensor")


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

    def chunked_operator(self, event_chunk: int = 4_000_000
                         ) -> MatmulOperator:
        """Streaming operator over this matrix's events
        (:func:`chunked_coo_operator`; the entries are already on their
        device and row-sorted)."""
        if self.nnz == 0:
            raise ValueError("empty matrix")
        return _stage_chunked(self.rows, self.cols, self.vals, self.shape,
                              event_chunk)

    def tiled_operator(self, event_chunk: int = 4_000_000,
                       tile: int = 128) -> MatmulOperator:
        """Tile-aligned streaming operator (:func:`tiled_coo_operator`)."""
        if self.nnz == 0:
            raise ValueError("empty matrix")
        return tiled_coo_operator(self.rows, self.cols, self.vals,
                                  self.shape, event_chunk=event_chunk,
                                  tile=tile, assume_sorted=True,
                                  dtype=self.vals.dtype)

    def split_operator(self, head_items="auto",
                       head_budget_gb: Optional[float] = 4.0,
                       event_chunk: int = 4_000_000,
                       tile: int = 128) -> MatmulOperator:
        """Head/tail split streaming operator (:func:`split_coo_operator`)."""
        if self.nnz == 0:
            raise ValueError("empty matrix")
        return split_coo_operator(self.rows, self.cols, self.vals,
                                  self.shape, head_items=head_items,
                                  head_budget_gb=head_budget_gb,
                                  event_chunk=event_chunk, tile=tile,
                                  assume_sorted=True,
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


# --------------------------------------------------------------------------
# streaming operators: beyond the dense block and the COO panel
# --------------------------------------------------------------------------

ArrayLike = Union[np.ndarray, torch.Tensor]


class StreamSide(NamedTuple):
    """One pass's events, sorted by the output (major) axis and cut into
    chunks.  With ``tile`` 1 (the chunked layout) each event owns its
    major id; otherwise every entity's events pad to whole tiles (zero
    values, minor id 0), and each tile of ``tile`` consecutive slots
    belongs to one entity.  Chunk ``c`` covers slots ``[e0, e1)`` and the
    output rows from ``first``; ``lengths[c]`` counts its units (events
    or tiles) per local output row, the segments of its sorted sum."""
    minor: torch.Tensor                     # (e_pad,) int64
    vals: torch.Tensor                      # (e_pad,)
    chunks: Tuple[Tuple[int, int, int], ...]  # (e0, e1, first) per chunk
    lengths: Tuple[torch.Tensor, ...]       # per chunk, int64
    tile: int


def _stream_pass(side: Optional[StreamSide], x: torch.Tensor,
                 out_dim: int) -> torch.Tensor:
    """``out[r] = Σ_{slots of r} vals · x[minor]`` over one staged side,
    one chunk at a time (the JAX package's ``_chunked_mm`` and
    ``_tiled_pass``): gather the chunk's rows of ``x``, scale (per event,
    or as a batched (1 x tile) x (tile x k) contraction per tile), reduce
    by a sorted segment sum over the chunk's local output rows and add it
    into the output in chunk order.  Peak memory beyond ``x`` and the
    output is one (chunk, k) panel; every sum runs in a fixed order, so
    two calls give the same bits.  Both layouts run it, so the chunked
    and tiled operators share ``_tiled_mm``/``_tiled_rmm``."""
    k = x.shape[1]
    out = x.new_zeros((out_dim, k))
    if side is None:
        return out
    tile = side.tile
    for (e0, e1, first), lengths in zip(side.chunks, side.lengths):
        y = x.index_select(0, side.minor[e0:e1])
        v = side.vals[e0:e1].to(x.dtype)
        if tile == 1:
            contrib = v[:, None] * y
        else:
            contrib = torch.matmul(v.view(-1, 1, tile),
                                   y.view(-1, tile, k))[:, 0]
        seg = torch.segment_reduce(contrib, "sum", lengths=lengths, axis=0)
        out[first:first + seg.shape[0]] += seg
    return out


def _chunk_plan(owner: torch.Tensor, units_per_chunk: int, tile: int
                ) -> Tuple[Tuple[Tuple[int, int, int], ...],
                           Tuple[torch.Tensor, ...]]:
    """Chunks of ``units_per_chunk`` units of a sorted owner array: the
    slot range and first owner of each (one host fetch of the chunks'
    first and last owners) and its units per local owner."""
    n_units = owner.shape[0]
    starts = torch.arange(0, n_units, units_per_chunk, device=owner.device)
    ends = torch.clamp(starts + units_per_chunk, max=n_units)
    ends_host = ends.tolist()
    firsts = owner[starts].tolist()
    lasts = owner[ends - 1].tolist()
    chunks, lengths = [], []
    for u0, u1, first, last in zip(starts.tolist(), ends_host, firsts,
                                   lasts):
        chunks.append((u0 * tile, u1 * tile, int(first)))
        lengths.append(torch.bincount(owner[u0:u1] - first,
                                      minlength=int(last - first) + 1))
    return tuple(chunks), tuple(lengths)


def _stage_chunked_side(maj: torch.Tensor, minor: torch.Tensor,
                        vals: torch.Tensor, event_chunk: int) -> StreamSide:
    """The chunked layout of one pass (``maj`` sorted ascending)."""
    event_chunk = max(1, min(int(event_chunk), maj.shape[0]))
    chunks, lengths = _chunk_plan(maj, event_chunk, 1)
    return StreamSide(minor=minor, vals=vals, chunks=chunks,
                      lengths=lengths, tile=1)


def _stage_tiled_side(maj: torch.Tensor, minor: torch.Tensor,
                      vals: torch.Tensor, n_major: int, event_chunk: int,
                      tile: int) -> StreamSide:
    """The tile-aligned layout of one pass (``maj`` sorted ascending).

    Every entity's event list pads to a multiple of ``tile`` (padding
    slots carry value 0 and minor id 0, as :func:`gather_padded_panels`
    builds them), and the padded stream cuts into chunks of
    ``event_chunk`` slots rounded up to whole tiles, the JAX package's
    rounding; the last chunk may be shorter (no shapes need be static).
    One host fetch of the padded tile count."""
    counts = torch.bincount(maj, minlength=n_major)
    pc = -(-counts // tile) * tile
    base = torch.cumsum(pc, 0) - pc
    ev_start = torch.cumsum(counts, 0) - counts
    tiles_per = pc // tile
    n_tiles = int(tiles_per.sum())                 # host sync (scalar)
    owner = torch.repeat_interleave(
        torch.arange(n_major, device=maj.device), tiles_per,
        output_size=n_tiles)
    minor_p, vals_p = gather_padded_panels(owner, base, counts, ev_start,
                                           minor, vals, n_tiles, tile)
    event_chunk = -(-min(int(event_chunk), n_tiles * tile) // tile) * tile
    chunks, lengths = _chunk_plan(owner, event_chunk // tile, tile)
    return StreamSide(minor=minor_p, vals=vals_p, chunks=chunks,
                      lengths=lengths, tile=tile)


def _events_on_device(rows: ArrayLike, cols: ArrayLike, vals: ArrayLike,
                      dtype: torch.dtype, device: Device, entry_point: str,
                      assume_sorted: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The event stream as (int64, int64, ``dtype``) tensors on the device
    (``device``; default a tensor input's, else the card), each moved
    once, stably sorted by row unless ``assume_sorted``.  Unsigned numpy
    ids widen to int64 before the move, so sortedness is tested on signed
    values."""
    if device is None and isinstance(rows, torch.Tensor):
        device = rows.device
    device = resolve_device(device, entry_point)

    def ids(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.int64)
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)

    rows, cols = ids(rows), ids(cols)
    vals = torch.as_tensor(vals).to(device=device, dtype=dtype)
    if not assume_sorted and not bool((rows[1:] >= rows[:-1]).all()):
        order = torch.argsort(rows, stable=True)
        rows, cols, vals = rows[order], cols[order], vals[order]
    return rows, cols, vals


def _tiled_mm(operands, x, out_dim):
    return _stream_pass(operands[0], x, out_dim)


def _tiled_rmm(operands, x, out_dim):
    return _stream_pass(operands[1], x, out_dim)


def _stage_chunked(rows: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, shape: Tuple[int, int],
                   event_chunk: int) -> MatmulOperator:
    """Row-sorted events -> the chunked operator: the row-sorted side for
    ``mm`` and a column-sorted copy (a stable sort, staged once) for
    ``rmm``."""
    m, n = (int(s) for s in shape)
    corder = torch.argsort(cols, stable=True)
    operands = (_stage_chunked_side(rows, cols, vals, event_chunk),
                _stage_chunked_side(cols[corder], rows[corder],
                                    vals[corder], event_chunk))
    return MatmulOperator(shape=(m, n), mm_fn=_tiled_mm,
                          rmm_fn=_tiled_rmm, operands=operands,
                          dtype=vals.dtype)


def chunked_coo_operator(rows: ArrayLike, cols: ArrayLike,
                         vals: ArrayLike, shape: Tuple[int, int],
                         event_chunk: int = 2_000_000,
                         assume_sorted: bool = False,
                         dtype: torch.dtype = torch.float32,
                         device: Device = None) -> MatmulOperator:
    """Streaming COO operator for matrices too large to densify
    (counterpart of the JAX package's ``chunked_coo_operator``).

    The plain :meth:`CooMatrix.operator` builds an (nnz, k) panel per
    product.  Here the row-sorted events are cut into chunks of
    ``event_chunk``: ``A @ x`` gathers a chunk's rows of ``x``, scales
    them, sums them per row (a sorted segment sum over the chunk's local
    rows, which are contiguous) and adds the result into the output in
    chunk order; a row that crosses a chunk boundary adds in two pieces.
    ``A.T @ x`` runs the same pass over a column-sorted copy, so no pass
    scatters floats with atomics.  Peak memory beyond the inputs and the
    output is one (event_chunk, k) panel."""
    if len(vals) == 0:
        raise ValueError("empty matrix")
    rows, cols, vals = _events_on_device(rows, cols, vals, dtype, device,
                                         "chunked_coo_operator",
                                         assume_sorted)
    return _stage_chunked(rows, cols, vals, shape, event_chunk)


def tiled_coo_operator(rows: ArrayLike, cols: ArrayLike, vals: ArrayLike,
                       shape: Tuple[int, int], event_chunk: int = 4_000_000,
                       tile: int = 128, assume_sorted: bool = False,
                       dtype: torch.dtype = torch.float32,
                       device: Device = None) -> MatmulOperator:
    """Tile-aligned streaming COO operator (counterpart of the JAX
    package's ``tiled_coo_operator``).

    ``A @ x`` streams a row-sorted copy and ``A.T @ x`` a column-sorted
    copy of the events, each entity's list padded to whole tiles of
    ``tile`` events, so each tile has one owner: a chunk reduces with one
    batched (1 x tile) x (tile x k) contraction and a sorted segment sum
    over tile owners (``tile`` times fewer segments than events).  Costs
    one padded copy of the stream per side (at most ``tile - 1`` padding
    slots per entity)."""
    if len(vals) == 0:
        raise ValueError("empty matrix")
    if tile < 1:
        raise ValueError("tile must be positive")
    rows, cols, vals = _events_on_device(rows, cols, vals, dtype, device,
                                         "tiled_coo_operator",
                                         assume_sorted)
    m, n = (int(s) for s in shape)
    row_side = _stage_tiled_side(rows, cols, vals, m, event_chunk, tile)
    corder = torch.argsort(cols, stable=True)
    col_side = _stage_tiled_side(cols[corder], rows[corder], vals[corder],
                                 n, event_chunk, tile)
    return MatmulOperator(shape=(m, n), mm_fn=_tiled_mm, rmm_fn=_tiled_rmm,
                          operands=(row_side, col_side), dtype=vals.dtype)


# --------------------------------------------------------------------------
# head/tail split: the Zipf head as a dense block
# --------------------------------------------------------------------------

# the head budget when none is set and the events lie on the CPU: the JAX
# package's streaming_head_gb default, so CPU runs pick its head width
CPU_HEAD_BUDGET_GB = 2.0


def resolve_head_budget(value: Optional[float], device) -> float:
    """The split head's budget in GiB: ``value`` when set; else a quarter
    of the free memory ``torch.cuda.mem_get_info`` reports on ``device``
    (a card), or :data:`CPU_HEAD_BUDGET_GB` on the CPU."""
    if value is not None:
        return float(value)
    device = torch.device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free / 4 / 2 ** 30
    return CPU_HEAD_BUDGET_GB


def _head_mm_blocks(d: torch.Tensor, head_ids: torch.Tensor,
                    x: torch.Tensor, out_dim: int) -> torch.Tensor:
    """Head part of ``A @ x``: ``D @ x[head_ids]``, one row block of the
    ``(n_blocks, block_rows, P)`` head at a time, each upcast to the
    panel's dtype just before its product (so a full-width floating copy
    of an int8 head never exists)."""
    n_blocks, br, _ = d.shape
    xh = x.index_select(0, head_ids)
    out = x.new_empty((n_blocks * br, x.shape[1]))
    for b in range(n_blocks):
        torch.matmul(d[b].to(x.dtype), xh, out=out[b * br:(b + 1) * br])
    return out[:out_dim]


def _head_rmm_blocks(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Head part of ``A.T @ x``: the (P, k) panel ``D.T @ x``, accumulated
    over the row blocks in order (the last block's padding rows, which
    hold no events, face no rows of ``x``)."""
    n_blocks, br, p = d.shape
    acc = x.new_zeros((p, x.shape[1]))
    for b in range(n_blocks):
        xb = x[b * br:(b + 1) * br]
        if xb.shape[0] == 0:
            break
        acc.addmm_(d[b, :xb.shape[0]].to(x.dtype).T, xb)
    return acc


def _split_mm(operands, x, out_dim):
    (d, head_ids), row_side, _ = operands
    out = _head_mm_blocks(d, head_ids, x, out_dim)
    if row_side is not None:
        out = out + _stream_pass(row_side, x, out_dim)
    return out


def _split_rmm(operands, x, out_dim):
    (d, head_ids), _, col_side = operands
    out = _stream_pass(col_side, x, out_dim)
    # tail events never reference head columns, so the head rows of the
    # tail pass are zeros; the ids are unique, so this is a plain write
    out[head_ids] = out[head_ids] + _head_rmm_blocks(d, x)
    return out


def _sorted_cell_sums(flat: torch.Tensor, v: torch.Tensor,
                      n_cells: int) -> torch.Tensor:
    """``out[c] = Σ_{flat = c} v`` in a fixed order: a stable sort by
    cell, a sorted segment sum, and a write to unique cells."""
    order = torch.argsort(flat, stable=True)
    cells, counts = torch.unique_consecutive(flat[order],
                                             return_counts=True)
    sums = torch.segment_reduce(v[order], "sum", lengths=counts, axis=0)
    return v.new_zeros(n_cells).index_put_((cells,), sums)


def build_head_block(hr: torch.Tensor, hp: torch.Tensor, hv: torch.Tensor,
                     m_pad: int, p: int, dtype: torch.dtype,
                     head_budget_gb: float = 4.0,
                     int8_ok: Optional[bool] = None,
                     _max_flat_cells: int = 2 ** 31 - 1) -> torch.Tensor:
    """Dense ``(m_pad, p)`` head block from head events: ``hr`` (padded)
    row ids, ``hp`` head-local column positions in ``[0, p)``, ``hv``
    values.  Shared by :func:`split_coo_operator` and the mesh tier
    (:func:`polara_tpu_torch.parallel.distributed.distributed_chunked_rsvd`).

    Cells accumulate as flat ids ``row * width + column`` within column
    groups of at most ``_max_flat_cells // m_pad`` columns (the JAX
    package's int32 bound; the whole block passes 2**31 cells at Netflix
    geometry) and at most the head budget's worth of ``dtype`` cells,
    which caps the staging transient.  Integer values (``int8_ok``) accumulate
    in int32 with ``index_add_``: integer sums are exact, so any order
    gives the same bits; other values take a sorted segment sum.  The
    block is stored int8 when every cell sum lies in [-127, 127] (a
    duplicated pair can sum past 127 even when each value fits), else in
    ``dtype``."""
    if int8_ok is None:
        int8_ok = bool(((hv == torch.round(hv)) & (hv.abs() <= 127)).all())
    itemsize = torch.empty((), dtype=dtype).element_size()
    pg = min(p, _max_flat_cells // m_pad)
    pg = min(pg, max(1, int(head_budget_gb * 2 ** 30)
                     // (m_pad * itemsize)))
    if pg < 1:      # pragma: no cover - matrices of > 2**31 rows
        raise ValueError("matrix has too many rows for one head column")
    hr, hp = hr.long(), hp.long()
    d = torch.empty((m_pad, p), dtype=torch.int8 if int8_ok else dtype,
                    device=hv.device)
    for g0 in range(0, p, pg):
        gw = min(pg, p - g0)
        sel = (hp >= g0) & (hp < g0 + gw)
        flat = hr[sel] * gw + (hp[sel] - g0)
        if int8_ok:
            acc = torch.zeros(m_pad * gw, dtype=torch.int32,
                              device=hv.device).index_add_(
                0, flat, hv[sel].to(torch.int32))
        else:
            acc = _sorted_cell_sums(flat, hv[sel], m_pad * gw)
        acc = acc.view(m_pad, gw)
        if d.dtype == torch.int8 and bool(acc.abs().max() > 127):
            d = d.to(dtype)      # int8 -> float is lossless
        d[:, g0:g0 + gw] = acc
    return d


def _top_items(counts: torch.Tensor, p: int) -> torch.Tensor:
    """The ``p`` largest counts' ids, ties to the lower id (``lax.top_k``'s
    rule), ascending."""
    order = torch.sort(counts, descending=True, stable=True).indices
    return torch.sort(order[:p]).values


def split_coo_operator(rows: ArrayLike, cols: ArrayLike, vals: ArrayLike,
                       shape: Tuple[int, int], head_items="auto",
                       head_budget_gb: Optional[float] = 4.0,
                       event_chunk: int = 4_000_000, tile: int = 32,
                       col_tile: int = 128, head_block_rows: int = 4096,
                       assume_sorted: bool = False,
                       min_coverage: float = 0.15,
                       dtype: torch.dtype = torch.float32,
                       _max_flat_cells: int = 2 ** 31 - 1,
                       device: Device = None) -> MatmulOperator:
    """Head/tail split streaming operator (counterpart of the JAX
    package's ``split_coo_operator``).

    Interaction logs are Zipf-skewed over items, so a dense ``(m, P)``
    block over the ``P`` most-rated items holds most of the events:

    * events on the top-``P`` items go once, at staging, into the head
      block ``D`` (:func:`build_head_block`), stored int8 when every cell
      sum is an integer in [-127, 127] (a storage format: the products
      are the f32 sums the tiled operator computes), as
      ``(n_blocks, head_block_rows, P)``; each product upcasts one row
      block and multiplies it with ``torch.matmul``;
    * the other events stay in the tile-aligned layout, ``tile`` on the
      row side (short per-user lists once the head is out) and
      ``col_tile`` on the column side.

    ``head_items="auto"`` sizes ``P`` from ``head_budget_gb``
    (:func:`resolve_head_budget`: None derives it from the device's free
    memory), rounded down to a multiple of 128 from 128 up.  When the
    head would hold less than ``min_coverage`` of the events, or ``P`` is
    0, the plain :func:`tiled_coo_operator` (``tile=col_tile``) is
    returned instead.  Head selection: the largest item counts, ties to
    the lower id."""
    if len(vals) == 0:
        raise ValueError("empty matrix")
    if tile < 1:
        raise ValueError("tile must be positive")
    rows, cols, vals = _events_on_device(rows, cols, vals, dtype, device,
                                         "split_coo_operator",
                                         assume_sorted)
    m, n = (int(s) for s in shape)
    nnz = rows.shape[0]
    budget = resolve_head_budget(head_budget_gb, rows.device)
    int8_ok = bool(((vals == torch.round(vals)) & (vals.abs() <= 127)).all())
    itemsize = 1 if int8_ok else torch.empty((), dtype=dtype).element_size()
    br = min(head_block_rows, m)
    n_blocks = -(-m // br)
    m_pad = n_blocks * br
    if head_items == "auto":
        p = int(budget * 2 ** 30) // (m * itemsize)
    else:
        p = int(head_items)
    p = min(p, n)
    if p >= 128:
        p = (p // 128) * 128

    def plain_tiled():
        return tiled_coo_operator(rows, cols, vals, (m, n),
                                  event_chunk=event_chunk, tile=col_tile,
                                  assume_sorted=True, dtype=dtype)

    if p < 1:
        return plain_tiled()
    if p < n:
        counts = torch.bincount(cols, minlength=n)
        head_ids = _top_items(counts, p)
        if float(counts[head_ids].sum()) / nnz < min_coverage:
            return plain_tiled()
        is_head = torch.zeros(n, dtype=torch.bool, device=rows.device)
        is_head[head_ids] = True
        mask = is_head[cols]
    else:
        head_ids = torch.arange(n, device=rows.device)
        mask = None
    head_pos = torch.zeros(n, dtype=torch.int64, device=rows.device)
    head_pos[head_ids] = torch.arange(p, device=rows.device)
    if mask is None:
        hr, hc, hv = rows, cols, vals
    else:
        hr, hc, hv = rows[mask], cols[mask], vals[mask]
    d = build_head_block(hr, head_pos[hc], hv, m_pad, p, dtype,
                         head_budget_gb=budget, int8_ok=int8_ok,
                         _max_flat_cells=_max_flat_cells
                         ).view(n_blocks, br, p)
    del hr, hc, hv
    row_side = col_side = None
    if mask is not None and not bool(mask.all()):
        tail = ~mask
        tr, tc, tv = rows[tail], cols[tail], vals[tail]
        row_side = _stage_tiled_side(tr, tc, tv, m, event_chunk, tile)
        corder = torch.argsort(tc, stable=True)
        col_side = _stage_tiled_side(tc[corder], tr[corder], tv[corder], n,
                                     event_chunk, col_tile)
    return MatmulOperator(shape=(m, n), mm_fn=_split_mm, rmm_fn=_split_rmm,
                          operands=((d, head_ids), row_side, col_side),
                          dtype=dtype)


# --------------------------------------------------------------------------
# padded per-row layout (seen lists, holdout lists)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddedRows:
    """Variable-length per-row integer lists padded to a rectangle
    (:class:`polara_tpu.ops.sparse.PaddedRows`): ``(n_rows, width)``
    index arrays plus a validity mask.  ``fill`` is a safe in-range index
    (0) so gathers never go out of bounds; consumers must honour
    ``mask``."""
    indices: np.ndarray   # int32 (n_rows, width)
    mask: np.ndarray      # bool  (n_rows, width)
    values: Optional[np.ndarray] = None  # aligned payload, same shape

    @property
    def shape(self):
        return self.indices.shape


def pad_rows(rows: np.ndarray, cols: np.ndarray,
             values: Optional[np.ndarray], n_rows: int,
             width: Optional[int] = None) -> PaddedRows:
    """Pack COO (row, col[, value]) into the padded-row layout (numpy,
    the JAX package's construction).  Requires ``rows`` sorted
    ascending."""
    rows = np.asarray(rows)
    counts = np.bincount(rows, minlength=n_rows)
    max_len = int(counts.max()) if counts.size else 0
    width = width or max(max_len, 1)
    if max_len > width:
        raise ValueError(f"row length {max_len} exceeds width {width}")
    positions = np.arange(len(rows)) - np.repeat(
        np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    indices = np.zeros((n_rows, width), dtype=np.int32)
    mask = np.zeros((n_rows, width), dtype=bool)
    indices[rows, positions] = cols
    mask[rows, positions] = True
    payload = None
    if values is not None:
        payload = np.zeros((n_rows, width), dtype=np.asarray(values).dtype)
        payload[rows, positions] = values
    return PaddedRows(indices=indices, mask=mask, values=payload)


# --------------------------------------------------------------------------
# batched inner products (sampled evaluation hot path)
# --------------------------------------------------------------------------

# bytes of one block's two (rows x t x rank) gathers in inner_product_at
GATHER_BLOCK_BYTES = 1 << 28


def inner_product_at(u: torch.Tensor, v: torch.Tensor, ui: torch.Tensor,
                     vi: torch.Tensor, block_rows: Optional[int] = None
                     ) -> torch.Tensor:
    """``out[b, t] = u[ui[b, t]] · v[vi[b, t]]`` on the factors' device.

    The gathers ``u[ui]`` and ``v[vi]`` are (b x t x rank) each, so the
    rows of ``ui``/``vi`` run in blocks of ``block_rows`` (default: two
    gathers within :data:`GATHER_BLOCK_BYTES`).  Each element is the sum of
    its own rank products, the same in every block, so the blocking does
    not change a bit of the result."""
    ui = torch.as_tensor(ui, device=u.device).long()
    vi = torch.as_tensor(vi, device=v.device).long()
    ui, vi = torch.broadcast_tensors(ui, vi)
    n_rows = ui.shape[0]
    if block_rows is None:
        per_row = 2 * max(1, ui[0].numel() if n_rows else 1) * u.shape[-1] \
            * u.element_size()
        block_rows = max(1, GATHER_BLOCK_BYTES // per_row)
    if block_rows >= n_rows:
        return (u[ui] * v[vi]).sum(-1)
    return torch.cat([(u[ui[lo:lo + block_rows]]
                       * v[vi[lo:lo + block_rows]]).sum(-1)
                      for lo in range(0, n_rows, block_rows)], 0)
