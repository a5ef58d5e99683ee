"""Fused factor scoring -> seen-item masking -> top-k.

Port of :mod:`polara_tpu.ops.pallas`.  :func:`fused_score_topk` returns,
per user row, the top-k of ``proj @ itemsᵀ`` with columns at or beyond
``n_valid_cols`` and seen items at -inf, ties to the lowest column, and
``PAD_CONST`` (value -inf) where fewer than k finite scores exist.

* On CUDA tensors it launches the hand-written kernel
  ``polara_tpu_torch/csrc/fused_topk.cu`` (built by
  :mod:`polara_tpu_torch.ops._cuda_build`), or raises.  The dense score
  block never exists in device memory.
* On CPU tensors it runs :func:`fused_score_topk_reference`, the plain
  version: an f32 matmul, the masks, a stable descending sort.

Seen items come as a packed bitmask in the natural layout: word
``col // 32``, bit ``col % 32``, held in an int32 tensor with the uint32
bit pattern (the TPU kernel's striped layout existed only for
``pltpu.repeat``).  Packing sets a repeated (row, col) pair's bit once;
clearing requires unique pairs, as the JAX plan's does.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from polara_tpu_torch.ops.topk import PAD_CONST

MAX_K = 128        # the TPU kernel's carry width; the CUDA kernel keeps it
STAGED_RANK = 256  # rank the CUDA kernel stages whole (kMaxStagedRank)
ITEM_TILE = 128    # items per tile of the CUDA kernel (kTile)
SLICED_ITEM_TILE = 256  # items per tile above STAGED_RANK (kSlicedTile)
USER_BLOCK = 64    # users per block of the CUDA kernel

_WORD_BITS = 32


def _n_words(n_cols: int) -> int:
    return max(1, -(-n_cols // _WORD_BITS))


def tile_items(rank: int) -> int:
    """Items per tile of the kernel that scores this rank."""
    return ITEM_TILE if rank <= STAGED_RANK else SLICED_ITEM_TILE


def panel_columns(n_valid: int, rank: int = 1) -> int:
    """Columns of the kernel's K-major panel scratch: ``n_valid`` rounded
    up to whole item tiles of this rank's kernel (the kernel zeroes the
    tail)."""
    tile = tile_items(rank)
    return -(-max(n_valid, 0) // tile) * tile


def item_tiles(n_valid: int, rank: int = 1) -> int:
    """Item tiles of the kernel's panel at this rank."""
    return panel_columns(n_valid, rank) // tile_items(rank)


def item_splits(n_users: int, n_tiles: int, blocks_per_sm: int,
                n_sms: int) -> int:
    """Item splits S of the kernel's grid, (user blocks, S).

    The card holds ``blocks_per_sm * n_sms`` blocks at once.  When the
    user blocks of 64 fill those slots, S = 1: the grid, shared memory
    and code path are those of an unsplit launch.  Otherwise the items
    are split so that the idle slots get work: S is the largest number of
    splits whose grid still fits in one wave (user blocks x S <= slots),
    at least 1 and at most ``n_tiles``.  Rounding S up instead, to fill
    every slot, would leave a second wave of the few blocks past the
    slots, each as long as a block of the first, and double the time.
    """
    user_blocks = -(-n_users // USER_BLOCK)
    slots = blocks_per_sm * n_sms
    if user_blocks == 0 or user_blocks >= slots:
        return 1
    return max(1, min(n_tiles, slots // user_blocks))


def split_columns(n_valid: int, splits: int, rank: int = 1):
    """The column range ``[lo, hi)`` of each of ``splits`` item splits, as
    the kernel of this rank deals them: tiles ``[s * n / S, (s + 1) * n /
    S)`` of its ``n`` tiles, clipped to ``n_valid``."""
    n_tiles, tile = item_tiles(n_valid, rank), tile_items(rank)
    if not 1 <= splits <= max(1, n_tiles):
        raise ValueError(f"splits must be in [1, {max(1, n_tiles)}] for "
                         f"{n_valid} columns at rank {rank}, got {splits}")
    return [(s * n_tiles // splits * tile,
             min(max(n_valid, 0), (s + 1) * n_tiles // splits * tile))
            for s in range(splits)]


def proj_columns(n_users: int) -> int:
    """Columns of the kernel's K-major proj scratch above
    ``STAGED_RANK``: ``n_users`` rounded up to whole user blocks."""
    return -(-n_users // USER_BLOCK) * USER_BLOCK


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding uint32 values -> int32 with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def pack_seen_bits(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
                   n_cols: int) -> torch.Tensor:
    """(n_rows, ceil(n_cols / 32)) int32 bitmask with bit (row, col) set,
    on the device of ``rows``.  Repeated pairs set their bit once (as the
    JAX plan's bitwise-or does): the flat bit indices are made unique
    first, so the bits summed into each word (in int64, free of
    overflow) are distinct and the sum composes like bitwise-or."""
    n_words = _n_words(n_cols)
    flat = torch.unique(rows.long() * (n_words * _WORD_BITS) + cols.long())
    word, bit = flat >> 5, flat & 31
    words = torch.zeros(n_rows * n_words, dtype=torch.int64,
                        device=rows.device)
    words.index_add_(0, word, torch.ones_like(bit) << bit)
    return _as_int32_bits(words).view(n_rows, n_words)


def clear_seen_bits(bits: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor) -> torch.Tensor:
    """Clear the (row, col) bits of a packed bitmask: the inverse of
    :func:`pack_seen_bits` for unique pairs whose bit is set (lets a
    holdout study reuse a full-stream mask without re-packing)."""
    n_rows, n_words = bits.shape
    rows = rows.long()
    cols = cols.long()
    clear = torch.zeros(n_rows * n_words, dtype=torch.int64,
                        device=bits.device)
    clear.index_add_(0, rows * n_words + (cols >> 5),
                     torch.ones_like(cols) << (cols & 31))
    words = (bits.reshape(-1).long() & 0xFFFFFFFF) & ~clear
    return _as_int32_bits(words).view(n_rows, n_words)


def seen_mask(bits: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Unpack a bitmask to a dense (n_rows, n_cols) bool tensor."""
    shifts = torch.arange(_WORD_BITS, device=bits.device, dtype=torch.int32)
    dense = (bits.unsqueeze(-1) >> shifts) & 1
    return dense.reshape(bits.shape[0], -1)[:, :n_cols].bool()


def fused_score_topk_reference(proj: torch.Tensor, items: torch.Tensor,
                               seen_bits: torch.Tensor, k: int,
                               filter_seen: bool = True,
                               n_valid_cols: Optional[int] = None,
                               return_values: bool = False):
    """Plain PyTorch version of :func:`fused_score_topk` (same contract,
    any device): f32 matmul, -inf masks, stable descending sort."""
    n_items = items.shape[0]
    n_valid = min(n_items, n_valid_cols if n_valid_cols is not None
                  else n_items)
    scores = proj.float() @ items.float().T
    col_ids = torch.arange(n_items, device=scores.device)
    scores = scores.masked_fill(col_ids >= n_valid, -torch.inf)
    if filter_seen:
        scores = scores.masked_fill(seen_mask(seen_bits, n_items),
                                    -torch.inf)
    order = torch.sort(scores, dim=1, descending=True, stable=True)
    vals = order.values[:, :k]
    idx = order.indices[:, :k].to(torch.int32)
    if k > n_items:
        pad = k - n_items
        vals = torch.nn.functional.pad(vals, (0, pad), value=-torch.inf)
        idx = torch.nn.functional.pad(idx, (0, pad), value=PAD_CONST)
    idx = idx.masked_fill(vals == -torch.inf, PAD_CONST)
    if return_values:
        return vals, idx
    return idx


def split_merge_reference(proj: torch.Tensor, items: torch.Tensor,
                          seen_bits: torch.Tensor, k: int, splits: int,
                          filter_seen: bool = True,
                          n_valid_cols: Optional[int] = None,
                          return_values: bool = False):
    """Plain version of the kernel's item split: the plain top-k of each
    split's column range (:func:`split_columns`), ids shifted by the
    range's first column, then a stable descending sort of the
    concatenated candidates (split 0 first), the first k kept.  Equals
    :func:`fused_score_topk_reference` for every ``splits``: it pins the
    merge's tie rule (an equal value keeps the lower column)."""
    n_items = items.shape[0]
    n_valid = min(n_items, n_valid_cols if n_valid_cols is not None
                  else n_items)
    vals, ids = [], []
    for lo, hi in split_columns(n_valid, splits, proj.shape[1]):
        v, i = fused_score_topk_reference(
            proj, items[lo:hi], seen_bits[:, lo // _WORD_BITS:], k,
            filter_seen=filter_seen, n_valid_cols=hi - lo,
            return_values=True)
        vals.append(v)
        ids.append(torch.where(i == PAD_CONST, i, i + lo))
    order = torch.sort(torch.cat(vals, dim=1), dim=1, descending=True,
                       stable=True)
    out_vals = order.values[:, :k]
    out_idx = torch.cat(ids, dim=1).gather(1, order.indices[:, :k])
    out_idx = out_idx.masked_fill(out_vals == -torch.inf, PAD_CONST)
    if return_values:
        return out_vals, out_idx
    return out_idx


# (device index, rank class, list slots) -> blocks per SM; device index ->
# SM count.  The occupancy is fixed by the built library, so it is asked
# once per process.
_blocks_per_sm = {}
_sm_count = {}


def kernel_blocks_per_sm(device: torch.device, rank: int, k: int) -> int:
    """Blocks of the score kernel that one SM of ``device`` holds at this
    rank and k (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` for the
    instantiation the launch uses); raises if the query fails."""
    import ctypes
    from polara_tpu_torch.ops._cuda_build import load_library

    rank_class = rank if rank <= STAGED_RANK else -1   # sliced: one layout
    key = (device.index, rank_class, -(-k // 32))
    if key not in _blocks_per_sm:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = load_library().polara_fused_blocks_per_sm(
                rank, k, ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"fused_score_topk occupancy query failed "
                               f"(cudaError_t {err}, {blocks.value} blocks "
                               f"per SM at rank {rank}, k {k})")
        _blocks_per_sm[key] = blocks.value
    return _blocks_per_sm[key]


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``."""
    if device.index not in _sm_count:
        _sm_count[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device.index]


def kernel_splits(device: torch.device, n_users: int, rank: int, k: int,
                  n_valid: int) -> int:
    """The item splits a launch on ``device`` takes (:func:`item_splits`
    at this device's occupancy and SM count)."""
    return item_splits(n_users, item_tiles(n_valid, rank),
                       kernel_blocks_per_sm(device, rank, k),
                       sm_count(device))


def _check_kernel_inputs(proj, items, seen_bits, n_valid, filter_seen):
    for name, t, dtype in (("proj", proj, torch.float32),
                           ("items", items, torch.float32),
                           ("seen_bits", seen_bits, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rank = proj.shape[1]
    if items.shape[1] != rank:
        raise ValueError(f"rank mismatch: proj {tuple(proj.shape)} vs "
                         f"items {tuple(items.shape)}")
    if rank < 1:
        raise ValueError(f"fused top-k kernel needs rank >= 1, got {rank}")
    if seen_bits.shape[0] != proj.shape[0]:
        raise ValueError("seen_bits must have one row per proj row")
    if filter_seen and seen_bits.shape[1] < -(-n_valid // _WORD_BITS):
        raise ValueError(f"seen_bits has {seen_bits.shape[1]} words per "
                         f"row; {n_valid} columns need "
                         f"{-(-n_valid // _WORD_BITS)}")
    if max(proj_columns(proj.shape[0]), items.shape[0], n_valid) >= 2 ** 31:
        raise ValueError("sizes must fit in int32")


def fused_score_topk(proj: torch.Tensor, items: torch.Tensor,
                     seen_bits: torch.Tensor, k: int,
                     filter_seen: bool = True,
                     n_valid_cols: Optional[int] = None,
                     return_values: bool = False,
                     tile_skip: bool = False,
                     _splits: Optional[int] = None
                     ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """Top-k of ``proj @ itemsᵀ`` per user: (n_users, k) int32 indices, or
    ``(values, indices)`` with ``return_values``.

    ``seen_bits``: (n_users, >= ceil(n_valid / 32)) int32 bitmask (see
    :func:`pack_seen_bits`).  Any rank >= 1, as the Pallas kernel: above
    ``STAGED_RANK`` the CUDA kernel walks the rank in slices.
    ``tile_skip`` is accepted for parity with the JAX API and changes
    nothing: the kernel's threshold test skips losing candidates either
    way.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, counted in
    ``fused_score_topk.launches`` (one per call).  When the users do not
    fill the card, the kernel splits the items over more blocks and
    merges their candidates (:func:`item_splits`); ids and values are
    those of one split bit for bit.  ``_splits`` pins the split count
    (None: the rule) so that tests can compare the two.
    """
    if k > MAX_K:
        raise ValueError(f"fused top-k supports k <= {MAX_K}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    devices = {proj.device, items.device, seen_bits.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    device = proj.device
    n_users, n_items = proj.shape[0], items.shape[0]
    n_valid = min(n_items, n_valid_cols if n_valid_cols is not None
                  else n_items)
    if _splits is not None:
        split_columns(n_valid, _splits, proj.shape[1])   # validates it
    if device.type == "cpu":
        return fused_score_topk_reference(
            proj, items, seen_bits, k, filter_seen=filter_seen,
            n_valid_cols=n_valid_cols, return_values=return_values)
    if device.type != "cuda":
        raise ValueError(f"fused_score_topk runs on CPU or CUDA tensors, "
                         f"not {device.type}")

    from polara_tpu_torch.ops._cuda_build import load_library

    _check_kernel_inputs(proj, items, seen_bits, n_valid, filter_seen)
    out_vals = torch.empty((n_users, k), dtype=torch.float32, device=device)
    out_idx = torch.empty((n_users, k), dtype=torch.int32, device=device)
    if n_users:
        lib = load_library()
        rank = proj.shape[1]
        splits = (kernel_splits(device, n_users, rank, k, n_valid)
                  if _splits is None else _splits)
        # scratch for the kernel's K-major copies of the panel and, above
        # STAGED_RANK, of proj; with item splits, for their candidates
        items_t = torch.empty((rank, panel_columns(n_valid, rank)),
                              dtype=torch.float32, device=device)
        proj_t = (torch.empty((rank, proj_columns(n_users)),
                              dtype=torch.float32, device=device)
                  if rank > STAGED_RANK else None)
        cand_vals = cand_idx = None
        if splits > 1:
            cand_vals = torch.empty((n_users, splits, k),
                                    dtype=torch.float32, device=device)
            cand_idx = torch.empty((n_users, splits, k), dtype=torch.int32,
                                   device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.polara_fused_score_topk(
                proj.data_ptr(), items.data_ptr(), items_t.data_ptr(),
                None if proj_t is None else proj_t.data_ptr(),
                seen_bits.data_ptr(), out_vals.data_ptr(), out_idx.data_ptr(),
                None if cand_vals is None else cand_vals.data_ptr(),
                None if cand_idx is None else cand_idx.data_ptr(),
                n_users, n_items, rank, seen_bits.shape[1], n_valid,
                k, int(filter_seen), splits, stream)
        if err != 0:
            raise RuntimeError(f"fused_score_topk kernel launch failed "
                               f"with cudaError_t {err}")
        fused_score_topk.launches += 1
    if return_values:
        return out_vals, out_idx
    return out_idx


fused_score_topk.launches = 0
