"""Chunked test-user scoring loop.

Counterpart of :mod:`polara_tpu.ops.scoring`: test users are cut into
uniform chunks planned against a device-memory budget; each chunk runs
score -> downvote -> top-k (:func:`run_scoring`) or, for factor models,
the fused kernel (:func:`run_scoring_fused`).  Chunks live on the plan's
``device``.

With a mesh (:mod:`polara_tpu_torch.runtime.mesh`) each chunk's rows
split over the ``users`` axis and every shard is scored and ranked on
its own device; the fused route may also split the item panel over the ``model``
axis and merge the shards' candidates.  The shards' results gather back
on the plan's device in shard order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.ops.fused_topk import fused_score_topk, pack_seen_bits
from polara_tpu_torch.ops.topk import (PAD_CONST, mask_and_topk,
                                       mask_and_topk_sharded, top_k_indices)
from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.memory import plan_user_chunks
from polara_tpu_torch.runtime.mesh import (Mesh, all_gather, device_grid,
                                           pad_to_multiple, users_devices)


class TestChunk(NamedTuple):
    """Uniformly shaped slice of the test data handed to a model scorer.

    ``rows`` are chunk-relative user rows; ``users`` are absolute test-user
    row ids (into the rebased 0..n_test-1 space); invalid entries are
    masked.  Valid events are sorted by row and invalid ones follow them
    (the segment-sum projections of the SVD family rely on it).
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
              device: Union[str, torch.device, None] = None,
              n_shards: int = 1,
              n_devices: Optional[int] = None) -> "ChunkedTestData":
        """``user_rows`` must be sorted ascending and *rebased* to test
        rows 0..n_users-1 (the data model guarantees both).  ``device``
        defaults to the card.  ``n_shards``: the mesh users-axis size, which
        chunk sizes align to; ``n_devices``: the distinct devices its
        shards lie on (:func:`~polara_tpu_torch.runtime.mesh.
        shard_device_count`, default ``n_shards``), which the budget for
        the row-sharded score block scales by."""
        device = resolve_device(device, "ChunkedTestData.build")
        if chunk_users is None:
            bounds = plan_user_chunks(n_users, n_items,
                                      scores_multiplier=scores_multiplier,
                                      budget_gb=budget_gb,
                                      n_shards=n_shards, n_devices=n_devices)
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


def _shard_chunk(chunk: TestChunk, lo: int, hi: int,
                 device: torch.device) -> TestChunk:
    """Rows ``[lo, hi)`` of a chunk as a chunk of their own on ``device``:
    the events of those rows, with rows made shard-relative."""
    sel = (chunk.rows >= lo) & (chunk.rows < hi)
    return TestChunk(start=chunk.start + lo,
                     users=chunk.users[lo:hi].to(device),
                     user_valid=chunk.user_valid[lo:hi].to(device),
                     rows=(chunk.rows[sel] - lo).to(device),
                     cols=chunk.cols[sel].to(device),
                     vals=chunk.vals[sel].to(device),
                     valid=chunk.valid[sel].to(device))


def _place_params(params: dict, devices: List[torch.device]) -> dict:
    """One copy of the params' tensors per distinct device, keyed by
    device (on the params' own device the tensors themselves)."""
    return {device: {name: (value.to(device)
                            if isinstance(value, torch.Tensor) else value)
                     for name, value in params.items()}
            for device in set(devices)}


def run_scoring(data: ChunkedTestData, score_fn: ScoreFn, params: dict,
                topk: int, filter_seen: bool = True,
                n_valid_cols: Optional[int] = None,
                on_device: bool = False, mesh: Optional[Mesh] = None):
    """Score every chunk, mask seen items, take top-k: an int32 array of
    shape (n_users, topk), as numpy by default or a tensor on the plan's
    device with ``on_device``.

    With ``mesh``, each chunk's rows split over the ``users`` axis and
    each shard is scored, masked and ranked on its own device: the scorer
    gets the shard as a chunk of its own (:func:`_shard_chunk`) and its
    device's copy of ``params``, and
    :func:`~polara_tpu_torch.ops.topk.mask_and_topk_sharded` keeps the
    ids equal to the unsharded block's.  So a scorer under a mesh must
    score each row from that row's events alone; a scorer that draws one
    random stream per chunk is scored without the mesh."""
    devices = None if mesh is None else users_devices(mesh)
    if devices is not None:
        placed = _place_params(params, devices)
        per = -(-data.chunk_users // len(devices))
    parts = []
    for c, chunk in enumerate(data.chunks):
        if mesh is None:
            recs = mask_and_topk(score_fn(params, chunk), chunk.rows,
                                 chunk.cols, chunk.valid, topk,
                                 filter_seen=filter_seen,
                                 n_valid_cols=n_valid_cols)
        else:
            shards = [score_fn(placed[device], _shard_chunk(
                          chunk, i * per, (i + 1) * per, device))
                      for i, device in enumerate(devices)
                      if i * per < data.chunk_users]
            recs = all_gather(mask_and_topk_sharded(
                shards, chunk.rows, chunk.cols, chunk.valid, topk,
                filter_seen=filter_seen, n_valid_cols=n_valid_cols),
                data.device)
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
                      item_order: Optional[str] = None,
                      mesh: Optional[Mesh] = None,
                      return_values: bool = False):
    """Like :func:`run_scoring` but through :func:`fused_score_topk`;
    with ``return_values``, ``(scores, ids)`` (PAD slots score -inf).

    ``proj_fn(params, chunk) -> (chunk_users, r)`` produces the user-side
    panel; ``params["item_panel"]`` is the (n_items, r) item-side panel.

    ``item_order="popularity"`` lays the item panel out in descending
    interaction-count order (the TPU kernel's tile-skip layout); returned
    positions map back to item ids, with PAD slots kept as PAD.  The top-k
    set is unchanged; equal-score ties resolve toward the more popular
    item instead of the lower id (documented deviation of the JAX
    package, kept).

    With ``mesh`` the kernel runs once per shard (the JAX package's
    ``shard_map`` steps): proj and seen-bit rows split over the
    ``users`` axis (padded to a multiple of it); when the mesh has a
    ``model`` axis of size > 1, the item panel and the seen-bit words
    split over it too, each shard takes its own top-k with values, and
    :func:`_fused_mesh_step_2d` merges the candidates.  The panel is
    copied to each mesh entry once per call, not once per chunk.
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
    n_model = 1
    if mesh is not None:
        n_dev = mesh.shape[mesh.axis_names[0]]
        if len(mesh.axis_names) > 1:
            n_model = mesh.shape[mesh.axis_names[1]]
    if n_model > 1:
        # each item shard a whole number of seen-bit words, so a shard's
        # words are a column slice of the chunk's
        shard_items = pad_to_multiple(-(-n_items // n_model), 32)
        total_pad = shard_items * n_model
        panel = torch.nn.functional.pad(panel, (0, 0, 0, total_pad - n_items))
        invalid_row = _invalid_col_bits(n_valid, total_pad, data.device)
        step = _fused_mesh_step_2d(mesh, topk, shard_items, tile_skip=ordered)
        panels = _place_panel(panel, mesh, shard_items)
    elif mesh is not None:
        step = _fused_mesh_step(mesh, topk, filter_seen, n_valid,
                                tile_skip=ordered)
        panels = _place_panel(panel, mesh, n_items)
    parts, scores = [], []
    for c, chunk in enumerate(data.chunks):
        proj = proj_fn(params, chunk).contiguous()
        if n_model > 1:
            if filter_seen:
                seen_bits = data.seen_bits(c, total_pad, col_map=col_map,
                                           map_token=map_token)
                seen_bits = seen_bits | invalid_row[None, :]
            else:
                seen_bits = invalid_row[None, :].expand(
                    proj.shape[0], invalid_row.shape[0])
        else:
            seen_bits = data.seen_bits(c, n_items, col_map=col_map,
                                       map_token=map_token)
        if mesh is None:
            vals, recs = fused_score_topk(proj, panel, seen_bits, topk,
                                          filter_seen=filter_seen,
                                          n_valid_cols=n_valid,
                                          return_values=True,
                                          tile_skip=ordered)
        else:
            pad = (-proj.shape[0]) % n_dev
            if pad:
                proj = torch.nn.functional.pad(proj, (0, 0, 0, pad))
                seen_bits = torch.nn.functional.pad(seen_bits,
                                                    (0, 0, 0, pad))
            vals, recs = step(proj, panels, seen_bits)
        if ordered:
            recs = torch.where(recs == PAD_CONST, PAD_CONST,
                               lookup[recs.clamp(min=0).long()])
        start = c * data.chunk_users
        stop = min(start + data.chunk_users, data.n_users)
        parts.append(recs[: stop - start])
        scores.append(vals[: stop - start])
    if return_values:
        return _collect(scores, on_device), _collect(parts, on_device)
    return _collect(parts, on_device)


def _invalid_col_bits(n_valid: int, n_cols_pad: int,
                      device: Union[str, torch.device] = "cpu"
                      ) -> torch.Tensor:
    """One seen-bit word row (natural layout, int32 words) with the bits
    of every column in ``[n_valid, n_cols_pad)`` set: ORed into the seen
    mask, it masks the padded columns of every item shard, so each shard
    runs the kernel with ``n_valid_cols`` = its full width."""
    cols = torch.arange(n_valid, n_cols_pad, device=device)
    return pack_seen_bits(torch.zeros_like(cols), cols, 1, n_cols_pad)[0]


def _place_panel(panel: torch.Tensor, mesh: Mesh, shard_items: int
                 ) -> np.ndarray:
    """The item panel on every (users, model) entry of the mesh: entry
    ``[i, j]`` holds rows ``[j * shard_items, (j + 1) * shard_items)`` on
    its device (the whole panel when the model axis has size 1).  Each
    device gets one copy of each slice; on the panel's own device the
    slice is a view."""
    grid = device_grid(mesh)
    placed = np.empty(grid.shape, dtype=object)
    copies = {}
    for (i, j), device in np.ndenumerate(grid):
        if (device, j) not in copies:
            copies[device, j] = panel[
                j * shard_items:(j + 1) * shard_items].to(device)
        placed[i, j] = copies[device, j]
    return placed


_step_cache: dict = {}


def _fused_mesh_step(mesh: Mesh, topk: int, filter_seen: bool, n_valid: int,
                     tile_skip: bool = False):
    """The kernel once per users shard (the JAX package's ``shard_map`` over
    ``users``): ``step(proj, panels, seen_bits)`` splits the rows of proj
    and of the seen bits into equal shards, launches each on its shard's
    device with that device's copy of the panel (``panels[i, 0]``), and
    gathers the scores and ids in shard order on proj's device.  Memoized
    per configuration, like the JAX package's compiled steps."""
    key = ("fused_mesh", mesh, topk, filter_seen, n_valid, tile_skip)
    step = _step_cache.get(key)
    if step is None:
        devices = users_devices(mesh)

        def step(proj, panels, seen_bits):
            per = proj.shape[0] // len(devices)
            vals, ids = [], []
            for i, device in enumerate(devices):
                rows = slice(i * per, (i + 1) * per)
                v, idx = fused_score_topk(
                    proj[rows].to(device), panels[i, 0],
                    seen_bits[rows].to(device), topk,
                    filter_seen=filter_seen, n_valid_cols=n_valid,
                    return_values=True, tile_skip=tile_skip)
                vals.append(v)
                ids.append(idx)
            return (all_gather(vals, proj.device),
                    all_gather(ids, proj.device))
        _step_cache[key] = step
    return step


def _fused_mesh_step_2d(mesh: Mesh, topk: int, shard_items: int,
                        tile_skip: bool = False):
    """The kernel once per (users shard, item shard) of a 2-D mesh, merged
    by score (two-stage distributed top-k).

    Each shard runs ``filter_seen=True`` with ``n_valid_cols`` =
    ``shard_items`` and ``return_values=True``: padded and invalid
    columns arrive masked in the seen bits (:func:`_invalid_col_bits`).
    Candidate ids, PAD excepted, are offset by the shard's first column;
    each users shard gathers its k x n_model candidates on its first
    device and keeps the first k of a stable descending sort.  Tie rule:
    within a shard the kernel keeps the lowest column, and the gather
    puts shards in ascending order, so the lowest global position wins
    whatever ``shard_items`` is.  (``torch.topk`` promises no order among
    ties on CUDA, so the merge does not use it.)  Returns the merged scores
    and ids; memoized like :func:`_fused_mesh_step`."""
    key = ("fused_mesh_2d", mesh, topk, shard_items, tile_skip)
    step = _step_cache.get(key)
    if step is None:
        grid = device_grid(mesh)
        words = shard_items // 32

        def step(proj, panels, seen_bits):
            n_dev, n_model = grid.shape
            per = proj.shape[0] // n_dev
            out_vals, out_ids = [], []
            for i in range(n_dev):
                rows = slice(i * per, (i + 1) * per)
                vals, ids = [], []
                for j in range(n_model):
                    device = grid[i, j]
                    v, idx = fused_score_topk(
                        proj[rows].to(device), panels[i, j],
                        seen_bits[rows, j * words:(j + 1) * words]
                        .to(device).contiguous(), topk, filter_seen=True,
                        n_valid_cols=shard_items, return_values=True,
                        tile_skip=tile_skip)
                    vals.append(v)
                    ids.append(torch.where(idx == PAD_CONST, PAD_CONST,
                                           idx + j * shard_items))
                vals, ids = _merge_candidates(vals, ids, topk, grid[i, 0])
                out_vals.append(vals)
                out_ids.append(ids)
            return (all_gather(out_vals, proj.device),
                    all_gather(out_ids, proj.device))
        _step_cache[key] = step
    return step


def _merge_candidates(vals: List[torch.Tensor], ids: List[torch.Tensor],
                      topk: int, device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second stage of the two-stage top-k: the item shards' (rows, k)
    candidate scores and global ids, gathered on ``device`` in shard order,
    and the first ``topk`` of a stable descending sort of each row."""
    vals = all_gather(vals, device, dim=1)
    ids = all_gather(ids, device, dim=1)
    pos = top_k_indices(vals, topk).long()
    return vals.gather(1, pos), ids.gather(1, pos)
