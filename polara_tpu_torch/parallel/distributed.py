"""Training and scoring over a device mesh (SVD subset).

Counterpart of the SVD part of :mod:`polara_tpu.parallel.distributed`.
The JAX package is single-controller: one process drives a mesh and GSPMD
inserts the collectives.  Here one process loops over the shards of a
:class:`~polara_tpu_torch.runtime.mesh.Mesh`, each shard's work on its own
device, and the collectives are the copies of
:func:`~polara_tpu_torch.runtime.mesh.psum` and
:func:`~polara_tpu_torch.runtime.mesh.all_gather`:

* **scoring**: test-user rows shard over the ``users`` axis; scoring is
  embarrassingly parallel (the seen-item shift needs two block-wide
  scalars), and the ids gather on the home device;
* **randomized SVD build**: the ratings matrix shards by rows and the
  tall panels with it.  Orthogonalization is CholeskyQR2: the b x b Gram
  is a ``psum`` over row shards, its Cholesky factor is tiny and kept on
  the home device, and the panel update is a local triangular solve.
  The only cross-shard traffic is the Grams and the (n x b) ``rmm``
  partials.

The event-sharded and dense distributed trainers of the JAX module
(``distributed_chunked_rsvd``, ``distributed_ials``,
``distributed_ials_events``, ``distributed_bpr``, ``distributed_hooi``)
are not ported yet.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import torch

from polara_tpu_torch.ops.rsvd import SvdResult, cholesky_qr2
from polara_tpu_torch.ops.scoring import _merge_candidates
from polara_tpu_torch.ops.sparse import dense_operator
from polara_tpu_torch.ops.topk import (mask_and_topk, mask_and_topk_sharded,
                                       top_k_indices)
from polara_tpu_torch.runtime.mesh import (Mesh, ShardedRows, all_gather,
                                           device_grid, psum, shard_rows)
from polara_tpu_torch.runtime.rng import generator_from_seed

Rows = Union[torch.Tensor, ShardedRows]


def _dist_rsvd_iterations(r_matrix: Rows, omega: torch.Tensor, n_iter: int,
                          k: int) -> SvdResult:
    """Subspace iteration with CholeskyQR2 over a (row-sharded) matrix;
    ``u`` comes back gathered on the home device without padding rows."""
    op = dense_operator(r_matrix)
    q, _ = cholesky_qr2(op.mm(omega))
    for _ in range(n_iter):
        z, _ = cholesky_qr2(op.rmm(q))
        q, _ = cholesky_qr2(op.mm(z))
    b = op.rmm(q).T                       # (block, n)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    if isinstance(u, ShardedRows):
        u = u.gather()
    return SvdResult(u=u[:, :k], s=s[:k], v=vt[:k, :].T)


def distributed_randomized_svd(r_matrix: torch.Tensor, k: int, mesh: Mesh,
                               oversample: Optional[int] = None,
                               n_iter: int = 8,
                               seed: int = 0) -> SvdResult:
    """Rank-k truncated SVD of a dense ratings matrix sharded by rows over
    the mesh ``users`` axis (zero-padded to a multiple of it); the k-wide
    panels of the item side stay whole on the home device.  The random
    start comes from a ``torch.Generator`` there (a different stream from
    the JAX package's)."""
    m, n = r_matrix.shape
    block = min(k + (oversample if oversample is not None else max(10, k)),
                min(m, n))
    sharded = shard_rows(r_matrix, mesh)
    gen = generator_from_seed(seed, sharded.device)
    omega = torch.randn((n, block), generator=gen, dtype=r_matrix.dtype,
                        device=sharded.device)
    return _dist_rsvd_iterations(sharded, omega, n_iter, k)


def score_mask_topk_step(item_factors: torch.Tensor, profiles: Rows,
                         seen_rows: torch.Tensor, seen_cols: torch.Tensor,
                         seen_valid: torch.Tensor, topk: int
                         ) -> torch.Tensor:
    """One inference step: ``(P·V)·Vᵀ`` -> downvote seen -> top-k.

    ``profiles`` may be a :class:`ShardedRows`: each users shard scores
    and ranks its rows on its own device
    (:func:`~polara_tpu_torch.ops.topk.mask_and_topk_sharded`) and the ids
    gather on the home device without the padding rows.  ``seen_rows``
    index the whole block."""
    if not isinstance(profiles, ShardedRows):
        scores = (profiles @ item_factors) @ item_factors.T
        return mask_and_topk(scores, seen_rows, seen_cols, seen_valid, topk)

    def scores_of(block):
        v = item_factors.to(block.device)
        return (block @ v) @ v.T
    parts = [scores_of(block) for block in profiles.blocks]
    recs = mask_and_topk_sharded(parts, seen_rows, seen_cols, seen_valid,
                                 topk)
    return all_gather(recs, profiles.device)[:profiles.n_rows]


class TrainEvalStepResult(NamedTuple):
    factors: SvdResult
    recommendations: torch.Tensor
    hit_count: torch.Tensor


def full_train_step(r_train: Rows, omega: torch.Tensor, profiles: Rows,
                    seen_rows: torch.Tensor, seen_cols: torch.Tensor,
                    seen_valid: torch.Tensor, holdout_items: torch.Tensor,
                    n_iter: int, k: int, topk: int) -> TrainEvalStepResult:
    """The whole distributed step: factorize -> score -> top-k -> hit count.

    ``r_train`` and ``profiles`` are row-sharded (:func:`shard_rows`) or
    whole; ``omega`` is the (n_items, block) random start.  The hits are
    counted over the gathered recommendations on the home device."""
    factors = _dist_rsvd_iterations(r_train, omega, n_iter, k)
    recs = score_mask_topk_step(factors.v, profiles, seen_rows, seen_cols,
                                seen_valid, topk)
    hits = (recs == holdout_items.to(recs.device)[:, None]).any(dim=1)
    return TrainEvalStepResult(factors=factors, recommendations=recs,
                               hit_count=hits.sum())


def sharded_score_topk_2d(item_factors: torch.Tensor, profiles: torch.Tensor,
                          topk: int, mesh: Mesh) -> torch.Tensor:
    """Scoring over a 2-D (users x model) mesh: users shard over the first
    axis, the item catalog over the second.

    Each (users shard, item shard) entry projects its profile block onto
    its item slice; the partial projections are summed over the model
    axis; each entry scores its item slice, sets seen items to -inf, takes
    a local top-k (ties to the lowest column) and offsets it to global
    ids; the users shard gathers the k x n_model candidates and keeps the
    first k of a stable descending sort: the two-stage distributed top-k.
    Matches ``mask_and_topk`` for k <= unseen items."""
    users_axis, model_axis = mesh.axis_names[0], mesh.axis_names[1]
    n_items = item_factors.shape[0]
    n_model = mesh.shape[model_axis]
    if n_items % n_model:
        raise ValueError(f"the model axis size {n_model} must divide "
                         f"the item axis {n_items}")
    grid = device_grid(mesh)
    per = -(-profiles.shape[0] // mesh.shape[users_axis])
    out = [_sharded_topk_2d_step(grid[i], item_factors,
                                 profiles[lo:lo + per], topk)
           for i, lo in enumerate(range(0, profiles.shape[0], per))]
    return all_gather(out, profiles.device)


def _sharded_topk_2d_step(devices, item_factors: torch.Tensor,
                          profiles: torch.Tensor, topk: int) -> torch.Tensor:
    """One users shard of :func:`sharded_score_topk_2d`: ``devices[j]``
    runs item shard j; the result lands on ``devices[0]``."""
    i_loc = item_factors.shape[0] // len(devices)
    v_local: List[torch.Tensor] = []
    local_profile: List[torch.Tensor] = []
    for j, device in enumerate(devices):
        cols = slice(j * i_loc, (j + 1) * i_loc)
        v_local.append(item_factors[cols].to(device))
        local_profile.append(profiles[:, cols].to(device))
    proj = psum([p @ v for p, v in zip(local_profile, v_local)], devices[0])
    vals, ids = [], []
    for j, device in enumerate(devices):
        scores = proj.to(device) @ v_local[j].T
        scores = scores.masked_fill(local_profile[j] > 0, -torch.inf)
        pos = top_k_indices(scores, min(topk, i_loc)).long()
        vals.append(scores.gather(1, pos))
        ids.append(pos + j * i_loc)
    return _merge_candidates(vals, ids, topk, devices[0])[1].to(torch.int32)
