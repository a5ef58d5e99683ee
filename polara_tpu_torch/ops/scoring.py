"""Chunked test-user scoring loop.

Counterpart of :mod:`polara_tpu.ops.scoring` (single device): test users
are cut into uniform chunks planned against a device-memory budget; each
chunk runs score -> downvote -> top-k (:func:`run_scoring`) or, for factor
models, the fused kernel (:func:`run_scoring_fused`).  Chunks live on the
plan's ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.ops.fused_topk import fused_score_topk, pack_seen_bits
from polara_tpu_torch.ops.topk import PAD_CONST, mask_and_topk
from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.memory import plan_user_chunks


class TestChunk(NamedTuple):
    """Uniformly shaped slice of the test data handed to a model scorer.

    ``rows`` are chunk-relative user rows; ``users`` are absolute test-user
    row ids (into the rebased 0..n_test-1 space); invalid entries are
    masked.
    """
    start: int               # first absolute user row
    users: torch.Tensor      # (chunk_users,) int64 absolute user row ids
    user_valid: torch.Tensor  # (chunk_users,) bool
    rows: torch.Tensor       # (width,) int64 chunk-relative rows of events
    cols: torch.Tensor       # (width,) int64 item ids of events
    vals: torch.Tensor       # (width,) f32 feedback values
    valid: torch.Tensor      # (width,) bool


@dataclasses.dataclass
class ChunkedTestData:
    """Plan: the user-sorted test COO cut into uniform chunks on
    ``device``."""
    chunks: List[TestChunk]
    chunk_users: int
    n_users: int
    n_items: int
    # per-item event counts over the test profiles (for the fused route's
    # popularity-ordered item layout); None = unknown
    item_counts: Optional[np.ndarray] = None
    device: torch.device = torch.device("cpu")

    @classmethod
    def build(cls, user_rows: np.ndarray, item_cols: np.ndarray,
              values: np.ndarray, n_users: int, n_items: int,
              chunk_users: Optional[int] = None,
              scores_multiplier: int = 1,
              budget_gb: Optional[float] = None,
              device: Union[str, torch.device, None] = None
              ) -> "ChunkedTestData":
        """``user_rows`` must be sorted ascending and *rebased* to test
        rows 0..n_users-1 (the data model guarantees both).  ``device``
        defaults to the card."""
        device = resolve_device(device, "ChunkedTestData.build")
        if chunk_users is None:
            bounds = plan_user_chunks(n_users, n_items,
                                      scores_multiplier=scores_multiplier,
                                      budget_gb=budget_gb)
            chunk_users = bounds[0][1] - bounds[0][0]
        n_chunks = -(-n_users // chunk_users)

        # uniform event-buffer width across chunks (the JAX package's one
        # compiled shape; kept so both packages cut identical chunks)
        split_pts = [int(np.searchsorted(user_rows, c * chunk_users))
                     for c in range(n_chunks + 1)]
        width = max(1, max(split_pts[c + 1] - split_pts[c]
                           for c in range(n_chunks)))

        def to_dev(array, dtype):
            return torch.as_tensor(array).to(device=device, dtype=dtype)

        chunks = []
        for c in range(n_chunks):
            lo, hi = split_pts[c], split_pts[c + 1]
            start = c * chunk_users
            stop = min(start + chunk_users, n_users)
            n_ev = hi - lo
            rows = np.zeros(width, dtype=np.int64)
            cols = np.zeros(width, dtype=np.int64)
            vals = np.zeros(width, dtype=np.float32)
            valid = np.zeros(width, dtype=bool)
            rows[:n_ev] = user_rows[lo:hi] - start
            cols[:n_ev] = item_cols[lo:hi]
            vals[:n_ev] = values[lo:hi]
            valid[:n_ev] = True

            users = np.minimum(start + np.arange(chunk_users), n_users - 1)
            user_valid = (start + np.arange(chunk_users)) < stop
            chunks.append(TestChunk(
                start=start,
                users=to_dev(users, torch.int64),
                user_valid=to_dev(user_valid, torch.bool),
                rows=to_dev(rows, torch.int64),
                cols=to_dev(cols, torch.int64),
                vals=to_dev(vals, torch.float32),
                valid=to_dev(valid, torch.bool)))
        return cls(chunks=chunks, chunk_users=chunk_users,
                   n_users=n_users, n_items=n_items,
                   item_counts=np.bincount(np.asarray(item_cols),
                                           minlength=n_items
                                           ).astype(np.int64),
                   device=device)

    def pop_order(self, n_valid: int) -> Tuple[np.ndarray, np.ndarray]:
        """Descending-popularity permutation over the first ``n_valid``
        items, cached per plan: ``perm[j]`` is the original id of the j-th
        most-interacted item (stable — count ties keep ascending id),
        ``inv`` the original -> position inverse.  Counts are integers.
        Plans built without counts order by plain id (identity)."""
        cache = self.__dict__.setdefault("_pop_order_cache", {})
        entry = cache.get(n_valid)
        if entry is None:
            counts = self.item_counts
            if counts is None:
                counts = np.zeros(n_valid, np.int64)
            counts = counts[:n_valid]
            if len(counts) < n_valid:
                counts = np.pad(counts, (0, n_valid - len(counts)))
            perm = np.argsort(-counts, kind="stable").astype(np.int64)
            inv = np.zeros(n_valid, np.int64)
            inv[perm] = np.arange(n_valid, dtype=np.int64)
            entry = cache[n_valid] = (perm, inv)
        return entry

    def seen_bits(self, chunk_idx: int, n_items: int,
                  col_map: Optional[np.ndarray] = None,
                  map_token=None) -> torch.Tensor:
        """Packed seen-item bitmask of a chunk on the plan's device,
        cached for the plan's lifetime.  ``col_map`` remaps item ids before
        packing (the popularity layout); ``map_token`` must identify the
        map for caching (e.g. ``("pop", n_valid)``)."""
        cache = self.__dict__.setdefault("_seen_bits_cache", {})
        key = (chunk_idx, n_items, map_token)
        bits = cache.get(key)
        if bits is None:
            chunk = self.chunks[chunk_idx]
            cols = chunk.cols[chunk.valid]
            if col_map is not None:
                cols = torch.as_tensor(col_map, device=self.device)[cols]
            bits = pack_seen_bits(chunk.rows[chunk.valid], cols,
                                  self.chunk_users, n_items)
            cache[key] = bits
        return bits

    def profile_matrix(self, chunk: TestChunk,
                       n_items: Optional[int] = None,
                       binary: bool = False,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Dense (chunk_users x n_items) interaction profile of a chunk."""
        n_items = n_items or self.n_items
        out = torch.zeros((self.chunk_users, n_items), dtype=dtype,
                          device=self.device)
        vals = torch.sign(chunk.vals) if binary else chunk.vals
        vals = torch.where(chunk.valid, vals, 0.0).to(dtype)
        return out.index_put_((chunk.rows, chunk.cols), vals,
                              accumulate=True)


# A scorer is a function (params, chunk) -> (chunk_users, n_items) scores.
ScoreFn = Callable[[dict, TestChunk], torch.Tensor]


def _collect(parts: List[torch.Tensor], on_device: bool):
    if on_device:
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)
    return np.concatenate([p.cpu().numpy() for p in parts], axis=0)


def run_scoring(data: ChunkedTestData, score_fn: ScoreFn, params: dict,
                topk: int, filter_seen: bool = True,
                n_valid_cols: Optional[int] = None,
                on_device: bool = False):
    """Score every chunk, mask seen items, take top-k: an int32 array of
    shape (n_users, topk), as numpy by default or a tensor on the plan's
    device with ``on_device``."""
    parts = []
    for c, chunk in enumerate(data.chunks):
        scores = score_fn(params, chunk)
        recs = mask_and_topk(scores, chunk.rows, chunk.cols, chunk.valid,
                             topk, filter_seen=filter_seen,
                             n_valid_cols=n_valid_cols)
        start = c * data.chunk_users
        stop = min(start + data.chunk_users, data.n_users)
        parts.append(recs[: stop - start])
    return _collect(parts, on_device)


def run_scores_only(data: ChunkedTestData, score_fn: ScoreFn,
                    params: dict) -> np.ndarray:
    """Raw dense scores for all test users (no masking/top-k)."""
    parts = []
    for c, chunk in enumerate(data.chunks):
        start = c * data.chunk_users
        stop = min(start + data.chunk_users, data.n_users)
        parts.append(score_fn(params, chunk)[: stop - start])
    return _collect(parts, on_device=False)


def run_scoring_fused(data: ChunkedTestData, proj_fn: ScoreFn, params: dict,
                      topk: int, filter_seen: bool = True,
                      n_valid_cols: Optional[int] = None,
                      on_device: bool = False,
                      item_order: Optional[str] = None):
    """Like :func:`run_scoring` but through :func:`fused_score_topk`.

    ``proj_fn(params, chunk) -> (chunk_users, r)`` produces the user-side
    panel; ``params["item_panel"]`` is the (n_items, r) item-side panel.

    ``item_order="popularity"`` lays the item panel out in descending
    interaction-count order (the TPU kernel's tile-skip layout); returned
    positions map back to item ids, with PAD slots kept as PAD.  The top-k
    set is unchanged; equal-score ties resolve toward the more popular
    item instead of the lower id (documented deviation of the JAX
    package, kept).
    """
    panel = params["item_panel"]
    n_items = panel.shape[0]
    n_valid = n_valid_cols if n_valid_cols is not None else n_items
    ordered = item_order == "popularity" and n_valid > 1
    col_map = map_token = lookup = None
    if ordered:
        perm, inv = data.pop_order(n_valid)
        col_map, map_token = inv, ("pop", n_valid)
        perm_full = np.concatenate([perm, np.arange(n_valid, n_items)])
        lookup = torch.as_tensor(perm_full, device=panel.device)
        panel = panel.index_select(0, lookup)
        lookup = lookup.to(torch.int32)
    panel = panel.contiguous()
    parts = []
    for c, chunk in enumerate(data.chunks):
        proj = proj_fn(params, chunk).contiguous()
        seen_bits = data.seen_bits(c, n_items, col_map=col_map,
                                   map_token=map_token)
        recs = fused_score_topk(proj, panel, seen_bits, topk,
                                filter_seen=filter_seen,
                                n_valid_cols=n_valid, tile_skip=ordered)
        if ordered:
            recs = torch.where(recs == PAD_CONST, PAD_CONST,
                               lookup[recs.clamp(min=0).long()])
        start = c * data.chunk_users
        stop = min(start + data.chunk_users, data.n_users)
        parts.append(recs[: stop - start])
    return _collect(parts, on_device)
