"""Implicit-feedback factorization: confidence-weighted ALS and BPR.

Counterpart of :mod:`polara_tpu.ops.implicit` (the reference delegates
these models to the ``implicit`` C library,
``polara/recommender/external/implicit/ialswrapper.py:13-91``,
``bprwrapper.py:7-76``):

* **iALS** (Hu/Koren/Volinsky): each half-sweep solves a batched stack of
  k x k normal systems ``(G + Yᵀdiag(c-1)Y) x = Yᵀ(c·p)``.  The dense tier
  (:func:`ials_train`) forms each batch's weighted Grams with one batched
  product over the dense ratings block, recomputing the confidence per
  batch; the event tier (:func:`ials_train_events`) forms them from each
  entity's own events in tile-aligned panels, summed per entity in a
  fixed order (two builds give the same bits on the card).
  :func:`ials_tier_work` estimates what each tier computes at an input's
  sizes; ``ImplicitALS`` routes a single-device build by it.  The solves
  are a batched Cholesky (``torch.linalg.cholesky_ex``): a system that is
  not positive definite raises at the end of its half-sweep, with no
  fallback.  The same solve is the warm-start fold-in
  (:func:`ials_fold_in`).
* **BPR** (Rendle et al.): minibatch SGD over sampled (user, pos, neg)
  triples; negatives drawn uniformly and masked against a dense seen
  matrix; the updates scatter-add with ``index_add_`` (atomics on the
  card, so two runs may differ in the last bits).

Random draws come from a ``torch.Generator`` on the device, a different
stream from ``jax.random``.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from polara_tpu_torch.ops.factorize import _input_device
from polara_tpu_torch.ops.sparse import gather_padded_panels
from polara_tpu_torch.runtime.rng import generator_from_seed

WeightFn = Union[str, Callable, None]

# numpy ufuncs given as confidence weights run as their torch counterparts
# (a ufunc raises on a CUDA tensor), with the callable's semantics: w(x)
_TORCH_UFUNCS = {np.log2: torch.log2, np.log: torch.log, np.sqrt: torch.sqrt}


def confidence(values: torch.Tensor, alpha: float = 1.0,
               weight: WeightFn = "log2",
               epsilon: float = 1.0) -> torch.Tensor:
    """Generic confidence transform ``alpha * w(r / eps)`` applied to the
    nonzero ratings (reference ``ialswrapper.py:46-50``); zero entries
    stay zero so the result is the ``C - 1`` margin over the unit
    baseline confidence.  The named ``"log2"``/``"log"`` weights compute
    ``w(x + 1)``; the callables ``np.log2``/``np.log`` compute ``w(x)``."""
    scaled = values / epsilon
    if weight is None:
        transformed = scaled
    elif isinstance(weight, str):
        if weight == "log2":
            transformed = torch.log2(torch.clamp(scaled, min=1e-12) + 1.0)
        elif weight == "log":
            transformed = torch.log(torch.clamp(scaled, min=1e-12) + 1.0)
        elif weight == "linear":
            transformed = scaled
        elif weight == "sqrt":
            transformed = torch.sqrt(torch.clamp(scaled, min=0.0))
        else:
            raise ValueError(f"Unknown confidence weight {weight!r}")
    elif callable(weight):
        transformed = _TORCH_UFUNCS.get(weight, weight)(scaled)
    else:
        raise ValueError(f"Unknown confidence weight {weight!r}")
    return torch.where(values > 0, alpha * transformed, 0.0)


class ImplicitFactors(NamedTuple):
    user: torch.Tensor
    item: torch.Tensor


def canonical_weight(weight: WeightFn) -> WeightFn:
    """Map a callable named ``sqrt`` (``np.sqrt``, ``torch.sqrt``: the
    reference notebooks' tuned iALS confidence) onto the named ``"sqrt"``
    weight, as the JAX package does.  Only sqrt maps: it equals the
    callable on the positive domain, whereas the named ``"log2"``/``"log"``
    compute ``w(x + 1)`` and are not the ``np.log2``/``np.log`` callables
    (``w(x)``, the reference wrapper's default), which keep their
    callable semantics."""
    if callable(weight) and getattr(weight, "__name__", None) == "sqrt":
        return "sqrt"
    return weight


def _cholesky_solve(a: torch.Tensor, rhs: torch.Tensor,
                    failures: List[torch.Tensor]) -> torch.Tensor:
    """Batched solve of SPD systems ``a x = rhs``; the factorization's
    status goes to ``failures`` (checked by :func:`_raise_if_failed`, so
    the card is not synchronized per batch)."""
    chol, info = torch.linalg.cholesky_ex(a)
    failures.append((info != 0).any())
    return torch.cholesky_solve(rhs[..., None], chol)[..., 0]


def _raise_if_failed(failures: List[torch.Tensor]) -> None:
    if failures and bool(torch.stack(failures).any()):
        raise torch.linalg.LinAlgError(
            "iALS normal system is not positive definite (raise the "
            "regularization)")


def _solve_cm1_block(cm1_b: torch.Tensor, other: torch.Tensor,
                     gram: torch.Tensor,
                     failures: List[torch.Tensor]) -> torch.Tensor:
    """Batched k x k normal-equation solve for one block of entities.

    ``cm1_b`` is the (batch, cols) confidence margin ``C - 1`` (zero where
    unobserved); peak intermediate is the (batch, cols, k) weighted panel.
    """
    pref = cm1_b > 0
    # rhs = Yᵀ (c ⊙ p) with c = cm1 + 1 on observed entries
    rhs = torch.where(pref, cm1_b + 1.0, 0.0) @ other          # (b, k)
    weighted = cm1_b[:, :, None] * other[None, :, :]            # (b, n, k)
    a = gram[None] + torch.matmul(weighted.transpose(1, 2), other)
    return _cholesky_solve(a, rhs, failures)


def _batch_starts(n_rows: int, batch_rows: int):
    """Clamped batch offsets covering [0, n_rows) without padding: the last
    batch backs up to end exactly at ``n_rows`` (rows solved twice get the
    identical answer: the fixed ``other`` side makes the solve per-row)."""
    batch_rows = min(batch_rows, n_rows)
    n_batches = -(-n_rows // batch_rows)
    starts = np.minimum(np.arange(n_batches) * batch_rows,
                        n_rows - batch_rows)
    return [int(s) for s in starts], batch_rows, n_batches


def _gram(other: torch.Tensor, reg: float) -> torch.Tensor:
    k = other.shape[1]
    return other.T @ other + reg * torch.eye(k, dtype=other.dtype,
                                             device=other.device)


def ials_half_sweep(cm1: torch.Tensor, other: torch.Tensor, reg: float,
                    batch_rows: int = 64) -> torch.Tensor:
    """Solve for one side's factors given the other side.

    ``cm1`` is the dense (rows x cols) confidence margin ``C - 1`` (zero
    where unobserved); ``other`` the (cols x k) fixed factors.  Rows are
    batched through clamped slices, so no padded copy of ``cm1`` is made
    and the only memory beyond the inputs is one (batch, cols, k) panel.
    """
    n_rows = cm1.shape[0]
    gram = _gram(other, reg)
    starts, b, _ = _batch_starts(n_rows, batch_rows)
    out = other.new_zeros((n_rows, other.shape[1]))
    failures: List[torch.Tensor] = []
    for start in starts:
        out[start:start + b] = _solve_cm1_block(cm1[start:start + b], other,
                                                gram, failures)
    _raise_if_failed(failures)
    return out


def _auto_batch_rows(n_rows: int, n_other: int, rank: int,
                     budget_bytes: int = 2 << 30) -> int:
    """Largest batch whose (batch, n_other, rank) weighted panel plus the
    product's temporary fit the budget (per-row independent solves make
    the result invariant to batching, so bigger batches only cut the
    number of sequential steps)."""
    per_row = max(1, n_other * rank * 4 * 2)
    b = budget_bytes // per_row
    b = max(8, min(1024, b, n_rows))
    return int(b) & ~7 or 8      # multiple of 8


def ials_train(dense_ratings: torch.Tensor, rank: int, alpha: float = 1.0,
               weight: WeightFn = "log2", epsilon: float = 1.0,
               reg: float = 0.01, num_epochs: int = 15,
               seed: Optional[int] = 0,
               batch_rows: Optional[int] = None,
               dtype: torch.dtype = torch.float32) -> ImplicitFactors:
    """Alternating sweeps over users and items on the dense ratings block,
    on its device.

    Memory-lean: the confidence margin ``C - 1`` is recomputed per batch
    from the ratings block inside the sweeps, and the item half-sweep
    reads a column slice of the block transposed, so neither ``C - 1``
    nor a transposed copy of the block is ever resident (at ML-10M
    geometry each is a ~3 GB f32 block)."""
    weight = canonical_weight(weight)
    n_users, n_items = dense_ratings.shape
    device = dense_ratings.device
    item_factors = _initial_item_factors(n_items, rank, seed, dtype, device)
    user_factors = torch.zeros((n_users, rank), dtype=dtype, device=device)
    batch_user = batch_rows or _auto_batch_rows(n_users, n_items, rank)
    batch_item = batch_rows or _auto_batch_rows(n_items, n_users, rank)
    user_factors, item_factors = _ials_epochs(
        dense_ratings, user_factors, item_factors, alpha, epsilon, reg,
        weight, num_epochs, batch_user, batch_item)
    return ImplicitFactors(user=user_factors, item=item_factors)


def _initial_item_factors(n_items: int, rank: int, seed: Optional[int],
                          dtype: torch.dtype, device) -> torch.Tensor:
    """The iALS starting point, N(0, 1/rank) from ``seed``'s generator on
    ``device`` (shared by every iALS trainer, so they start alike)."""
    gen = generator_from_seed(seed, device)
    return (torch.randn((n_items, rank), generator=gen, dtype=dtype,
                        device=device) * (1.0 / math.sqrt(rank)))


def _ials_sweep(dense, other, alpha, epsilon, reg, weight: WeightFn,
                batch_rows: int, axis: int) -> torch.Tensor:
    """One half-sweep solving factors for rows (``axis=0``) or columns
    (``axis=1``) of the raw ratings block, applying the confidence
    transform blockwise (a column block is read transposed)."""
    n_rows = dense.shape[axis]
    dtype = other.dtype
    gram = _gram(other, reg)
    starts, b, _ = _batch_starts(n_rows, batch_rows)
    out = other.new_zeros((n_rows, other.shape[1]))
    failures: List[torch.Tensor] = []
    for start in starts:
        if axis == 0:
            blk = dense[start:start + b]
        else:
            blk = dense[:, start:start + b].T
        cm1_b = confidence(blk.to(dtype), alpha, weight,
                           epsilon).contiguous()
        out[start:start + b] = _solve_cm1_block(cm1_b, other, gram,
                                                failures)
    _raise_if_failed(failures)
    return out


def _ials_epochs(dense, user_factors, item_factors, alpha, epsilon, reg,
                 weight: WeightFn, num_epochs: int, batch_user: int,
                 batch_item: int):
    """``num_epochs`` alternating sweeps (users, then items) from the given
    factors; returns the new (user_factors, item_factors)."""
    weight = canonical_weight(weight)
    for _ in range(num_epochs):
        user_factors = _ials_sweep(dense, item_factors, alpha, epsilon,
                                   reg, weight, batch_user, axis=0)
        item_factors = _ials_sweep(dense, user_factors, alpha, epsilon,
                                   reg, weight, batch_item, axis=1)
    return user_factors, item_factors


class EllSide(NamedTuple):
    """Tile-aligned event stream for one half-sweep of the streaming iALS
    (see :func:`ials_train_events`).

    Every entity's event list is padded to a multiple of ``tile`` and laid
    out contiguously, so each tile of ``tile`` events belongs to exactly
    one entity: per-tile normal-equation contributions become batched
    products, and the per-entity reduction is a sorted segment sum over
    tile owners.  Entities batch in natural order under an event budget
    (variable entity counts per batch, equalized tile spans), so skewed
    sides (the popular item head) never blow a window up.  Each batch
    covers a clamped window of ``tb`` tiles; tiles inside the window that
    belong to another batch map to a dump segment, and each batch writes
    back only its own ``n_ents`` rows, so overlapping or zero-entity
    batches are no-ops.  The batch plan (``starts``, ``ent_starts``,
    ``n_ents``) stays on the host.
    """
    minor: torch.Tensor        # (e_pad,) int64 other-side ids, 0 on padding
    w: torch.Tensor            # (e_pad,) C-1 margins, 0 on padding
    starts: np.ndarray         # (n_batches,) tile offset per batch
    ent_starts: np.ndarray     # (n_batches,) first entity per batch
    n_ents: np.ndarray         # (n_batches,) entities owned per batch
    owner_local: torch.Tensor  # (n_batches, tb) int64 in [0, batch_entities]
    n_entities: int
    batch_entities: int        # segment width per batch (>= max n_ents)
    tile: int


class EventPanels(NamedTuple):
    """Device-staged tile panels of one event side at natural (unpadded)
    size: the expensive half of :func:`stage_events_side`, computed once
    and shared across restages that only force geometry."""
    minor: torch.Tensor        # (nat_tiles*tile,) int64
    w: torch.Tensor            # (nat_tiles*tile,) weights
    owner: torch.Tensor        # (nat_tiles,) int64 tile -> entity
    tiles_np: np.ndarray       # host per-entity tile counts
    n_major: int
    tile: int


def stage_events_panels(maj: torch.Tensor, minor: torch.Tensor,
                        cm1: torch.Tensor, n_major: int,
                        tile: int = 128) -> EventPanels:
    """Device staging of one side's tile-aligned panels (``maj`` must be
    sorted ascending): per-entity tile counts, tile-owner table, and
    gather-built (minor, weight) panels."""
    maj = maj.long()
    counts = torch.bincount(maj, minlength=n_major)
    pc = -(-counts // tile) * tile                 # tile-padded counts
    base = torch.cumsum(pc, 0) - pc                # dest base per entity
    ev_start = torch.cumsum(counts, 0) - counts

    tiles_np = (pc // tile).cpu().numpy().astype(np.int64)   # host fetch
    nat_tiles = int(tiles_np.sum())
    owner = torch.repeat_interleave(
        torch.arange(n_major, device=maj.device),
        torch.as_tensor(tiles_np, device=maj.device),
        output_size=nat_tiles)
    minor_p, w_p = gather_padded_panels(owner, base, counts, ev_start,
                                        minor, cm1, nat_tiles, tile)
    return EventPanels(minor=minor_p, w=w_p, owner=owner,
                       tiles_np=tiles_np, n_major=n_major, tile=tile)


def stage_events_side(maj: torch.Tensor, minor: torch.Tensor,
                      cm1: torch.Tensor, n_major: int, tile: int = 128,
                      batch_entities: int = 4096,
                      max_window_events: int = 4_000_000,
                      pad_events_to: int = 0,
                      window_tiles: int = 1,
                      pad_batches_to: int = 0,
                      min_batch_entities: int = 0,
                      panels: Optional[EventPanels] = None) -> EllSide:
    """Stage one :class:`EllSide` (gather on device, plan on host).

    ``maj`` must be sorted ascending (sort the column side first).  One
    host fetch of the per-entity tile counts drives the greedy batch
    plan: consecutive entities pack into a batch until its tile span
    would exceed ``max_window_events`` (or the entity count exceeds
    ``batch_entities``), so peak live memory per half-sweep step is about
    ``max_window_events x k`` floats whatever the popularity skew.

    ``pad_events_to`` / ``window_tiles`` / ``pad_batches_to`` /
    ``min_batch_entities`` force minimum shapes so several independently
    staged sides share one geometry; all four only inflate (zero-weight
    tail tiles, zero-entity batches, wider windows and segment counts
    whose extra rows the ``n_ents`` write mask drops).  ``panels`` skips
    the device staging for such restages.
    """
    if panels is None:
        panels = stage_events_panels(maj, minor, cm1, n_major, tile)
    tiles_np = panels.tiles_np
    cum = np.concatenate(([0], np.cumsum(tiles_np)))
    nat_tiles = int(cum[-1])
    if nat_tiles == 0 and not pad_events_to:
        raise ValueError("empty event stream")
    e_pad = max(nat_tiles * tile,
                -(-int(pad_events_to) // tile) * tile)
    n_tiles = e_pad // tile

    minor_p, w_p, owner = panels.minor, panels.w, panels.owner
    if n_tiles > nat_tiles:
        # trailing pad tiles carry zero-weight events and belong to the
        # clamped last entity id (keeps owner ids sorted): an append only
        pad_t = n_tiles - nat_tiles
        owner = torch.cat([owner, owner.new_full((pad_t,), n_major - 1)])
        minor_p = torch.cat([minor_p, minor_p.new_zeros(pad_t * tile)])
        w_p = torch.cat([w_p, w_p.new_zeros(pad_t * tile)])

    # greedy equalized batch plan (host, O(n_batches) searchsorted steps)
    budget_tiles = max(1, -(-int(max_window_events) // tile))
    be_cap = max(1, min(batch_entities, n_major))
    b_start, b_ents = [], []
    s = 0
    while s < n_major:
        e = int(np.searchsorted(cum, cum[s] + budget_tiles,
                                side="right")) - 1
        e = min(max(e, s + 1), s + be_cap, n_major)
        b_start.append(s)
        b_ents.append(e - s)
        s = e
    be_seg = min(max(max(b_ents), int(min_batch_entities), 1), n_major)
    ent0 = np.minimum(np.asarray(b_start), n_major - be_seg)
    # coverage from the clamped start: clamped-in earlier entities are
    # fully inside the window, so the batch recomputes them correctly and
    # overlap between batches is idempotent
    n_ents = np.minimum(np.asarray(b_start) + np.asarray(b_ents),
                        n_major) - ent0
    span = cum[ent0 + n_ents] - cum[ent0]
    tb = max(int(span.max()), 1, int(window_tiles))
    if tb * tile > e_pad:
        raise ValueError(
            f"window of {tb} tiles exceeds the padded event stream "
            f"({e_pad} events); raise pad_events_to to at least "
            f"{tb * tile}")
    if pad_batches_to > len(ent0):                 # zero-entity no-ops
        extra = pad_batches_to - len(ent0)
        ent0 = np.concatenate([ent0, np.zeros(extra, ent0.dtype)])
        n_ents = np.concatenate([n_ents, np.zeros(extra, n_ents.dtype)])
    raw_start = np.minimum(cum[ent0], n_tiles - tb)

    device = owner.device
    idx = (torch.as_tensor(raw_start, device=device)[:, None]
           + torch.arange(tb, device=device)[None, :])
    ol = owner[idx] - torch.as_tensor(ent0, device=device)[:, None]
    ol = torch.where((ol >= 0)
                     & (ol < torch.as_tensor(n_ents, device=device)[:, None]),
                     ol, be_seg)
    return EllSide(minor=minor_p, w=w_p, starts=raw_start.astype(np.int64),
                   ent_starts=ent0.astype(np.int64),
                   n_ents=n_ents.astype(np.int64), owner_local=ol,
                   n_entities=n_major, batch_entities=be_seg, tile=tile)


def _owner_lengths(owner_local: torch.Tensor,
                   batch_entities: int) -> torch.Tensor:
    """Each batch window's tiles per segment, in window order: the
    window's leading tiles of earlier batches, then each of the batch's
    ``batch_entities`` entities, then its trailing tiles (of later
    batches, padding and unowned entities) -- (n_batches,
    batch_entities + 2).  Owners ascend through a window, so these
    segments are contiguous; the counts are integer sums, exact in any
    order."""
    owned = owner_local < batch_entities
    leading = ~owned & (torch.cumsum(owned, 1) == 0)
    segment = torch.where(owned, owner_local + 1,
                          torch.where(leading, 0, batch_entities + 1))
    return torch.zeros((owner_local.shape[0], batch_entities + 2),
                       dtype=torch.int64, device=owner_local.device
                       ).scatter_add_(1, segment, torch.ones_like(segment))


def _ell_half_sweep(minor_p, w_p, starts, ent_starts, n_ents, owner_local,
                    other, reg, n_entities: int, batch_entities: int,
                    tile: int) -> torch.Tensor:
    """One streaming half-sweep: solve every entity's k x k normal system
    from its tile-aligned events.

    Per batch window: gather the other side's factor rows for the
    window's events, form per-tile Gram/rhs contributions as batched
    products (the nnz·k² work), sum them by local owner (a sorted segment
    sum: one thread per output element adds its entity's tiles in order,
    so two builds give the same bits on the card, where ``index_add_``'s
    atomics do not) and run one batched Cholesky solve.  Peak live memory
    is one (tb·tile, k) gather window, bounded by the staging event
    budget.  Each batch writes back only its own ``n_ents`` rows.
    """
    k = other.shape[1]
    tb = owner_local.shape[1]
    gram = _gram(other, reg)
    rowid = torch.arange(batch_entities, device=other.device)[:, None]
    out = other.new_zeros((n_entities, k))
    failures: List[torch.Tensor] = []
    lengths = _owner_lengths(owner_local, batch_entities)
    for st, ent0, ne, lens in zip(starts, ent_starts, n_ents, lengths):
        ev0, ent0 = int(st) * tile, int(ent0)
        msl = minor_p[ev0:ev0 + tb * tile]
        wsl = w_p[ev0:ev0 + tb * tile]
        y = other[msl].view(tb, tile, k)
        yw = y * wsl.view(tb, tile)[..., None]
        gt = torch.matmul(yw.transpose(1, 2), y)                # (tb, k, k)
        rw = (wsl + (wsl > 0).to(wsl.dtype)).view(tb, tile)
        rt = torch.matmul(rw[:, None, :], y)[:, 0]              # (tb, k)
        # unsafe: skip the lengths' checks, two host syncs a call;
        # _owner_lengths' counts are whole and sum to the window
        g = torch.segment_reduce(gt, "sum", lengths=lens, axis=0,
                                 unsafe=True)
        r = torch.segment_reduce(rt, "sum", lengths=lens, axis=0,
                                 unsafe=True)
        a = gram[None] + g[1:batch_entities + 1]
        x = _cholesky_solve(a, r[1:batch_entities + 1], failures)
        cur = out[ent0:ent0 + batch_entities]
        out[ent0:ent0 + batch_entities] = torch.where(rowid < int(ne), x,
                                                      cur)
    _raise_if_failed(failures)
    return out


def ials_train_events(rows, cols, vals, shape, rank: int,
                      alpha: float = 1.0, weight: WeightFn = "log2",
                      epsilon: float = 1.0, reg: float = 0.01,
                      num_epochs: int = 15, seed: Optional[int] = 0,
                      tile: int = 128, batch_entities: int = 4096,
                      max_window_events: int = 4_000_000,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> ImplicitFactors:
    """Streaming iALS over the raw event stream: the tier for ratings
    whose dense block does not fit the device budget.

    Each half-sweep assembles every entity's normal equations from its
    own events only (``YᵀC_uY = YᵀY + Σ_e (c_e−1) y_e y_eᵀ``, reference
    ``ialswrapper.py:46-60``) in tile-aligned panels (:class:`EllSide`).
    Same start, sweep order and epoch count as :func:`ials_train`, so the
    two differ by the order of float sums.  ``rows``/``cols``/``vals`` are
    numpy arrays or tensors; the training runs on ``device`` (default:
    the inputs' device for tensors, else the card).
    """
    weight = canonical_weight(weight)
    device = _input_device(device, rows, "ials_train_events")
    n_users, n_items = (int(s) for s in shape)
    nnz = len(vals)
    if nnz == 0:
        raise ValueError("empty matrix")

    rows_d = torch.as_tensor(rows).to(device=device, dtype=torch.int64)
    cols_d = torch.as_tensor(cols).to(device=device, dtype=torch.int64)
    vals_d = torch.as_tensor(vals).to(device=device, dtype=dtype)
    cm1 = confidence(vals_d, alpha, weight, epsilon)

    if not bool((rows_d[1:] >= rows_d[:-1]).all()):
        order = torch.argsort(rows_d, stable=True)
        rows_d, cols_d, cm1 = rows_d[order], cols_d[order], cm1[order]
    user_side = stage_events_side(rows_d, cols_d, cm1, n_users,
                                  tile=tile,
                                  batch_entities=batch_entities,
                                  max_window_events=max_window_events)
    corder = torch.argsort(cols_d, stable=True)
    item_side = stage_events_side(cols_d[corder], rows_d[corder],
                                  cm1[corder], n_items, tile=tile,
                                  batch_entities=min(batch_entities,
                                                     n_items),
                                  max_window_events=max_window_events)

    item_factors = _initial_item_factors(n_items, rank, seed, dtype, device)
    user_factors = torch.zeros((n_users, rank), dtype=dtype, device=device)

    def half(side: EllSide, other):
        return _ell_half_sweep(side.minor, side.w, side.starts,
                               side.ent_starts, side.n_ents,
                               side.owner_local, other, reg,
                               n_entities=side.n_entities,
                               batch_entities=side.batch_entities,
                               tile=side.tile)

    for _ in range(num_epochs):
        user_factors = half(user_side, item_factors)
        item_factors = half(item_side, user_factors)
    return ImplicitFactors(user=user_factors, item=item_factors)


# The event tier's seconds per unit of :func:`ials_tier_work` over the
# dense tier's where the two builds take equal time (54% density at
# 8,000 x 4,000, rank 50), measured on an H100 (PERF.md, "iALS tiers")
EVENT_TIER_COST = 1.85


def ials_tier_work(n_users: int, n_items: int, nnz: int, rank: int,
                   num_epochs: int) -> dict:
    """Multiply-adds that each single-device iALS tier spends where the
    two differ, at an input's sizes; the Cholesky solves, alike in both,
    are left out.

    ``dense``: every half-sweep pair forms the normal systems over all
    ``2·n_users·n_items`` cells, each a rank-one Gram update (k²) and a
    right-hand-side term (k).  ``events``: the same per tile-padded event
    of both sides (``2·nnz`` events, half a 128-event tile of padding per
    entity), plus the build's staging: two sorts of the events and one
    pass over the padded panels.  ``events`` is scaled by :data:`EVENT_TIER_COST`,
    so the cheaper tier has the smaller number."""
    per_cell = rank * rank + rank
    dense = 2.0 * num_epochs * n_users * n_items * per_cell
    padded = 2.0 * nnz + (n_users + n_items) * 64
    staging = 2.0 * nnz * math.log2(max(nnz, 2)) + padded * rank
    events = num_epochs * padded * per_cell + staging
    return {"dense": dense, "events": EVENT_TIER_COST * events}


def ials_fold_in(profiles: torch.Tensor, item_factors: torch.Tensor,
                 alpha: float = 1.0, weight: WeightFn = "log2",
                 epsilon: float = 1.0, reg: float = 0.01,
                 batch_rows: Optional[int] = None) -> torch.Tensor:
    """Warm-start user vectors from raw test profiles in one batched solve
    (replaces the reference's per-user ``recalculate_user`` loop)."""
    cm1 = confidence(profiles.to(item_factors.dtype), alpha,
                     canonical_weight(weight), epsilon)
    if batch_rows is None:
        batch_rows = _auto_batch_rows(cm1.shape[0], cm1.shape[1],
                                      item_factors.shape[1])
    return ials_half_sweep(cm1, item_factors, reg, batch_rows)


def _bpr_update(x, y, u, i, j, xu, yi, yj, g, okf, lr, reg) -> None:
    """The BPR step's scatter-add update, in place: ``xu, yi, yj`` are the
    rows gathered before any write (as the JAX package's ``.at[].add``
    chain reads them), ``g`` and ``okf`` (batch, 1) columns."""
    x.index_add_(0, u, lr * (g * (yi - yj) - reg * okf * xu))
    y.index_add_(0, i, lr * (g * xu - reg * okf * yi))
    y.index_add_(0, j, lr * (-g * xu - reg * okf * yj))


def _sigmoid_neg(margin: torch.Tensor) -> torch.Tensor:
    """``sigmoid(-margin)``, the BPR gradient scale, as ``1 / (1 +
    exp(margin))``: on the CPU ``torch.sigmoid`` rounds some elements
    differently in short and long tensors, and the mesh trainer computes
    it over slices of the batch."""
    return 1.0 / (1.0 + torch.exp(margin))


def _bpr_draw(gen, nnz: int, n_items: int, batch_size: int, device):
    """One step's sampled (event index, negative item) draws."""
    idx = torch.randint(0, nnz, (batch_size,), generator=gen, device=device)
    j = torch.randint(0, n_items, (batch_size,), generator=gen,
                      device=device)
    return idx, j


def _bpr_epoch(user_factors, item_factors, seen, rows, cols, gen,
               n_steps: int, batch_size: int, lr: float, reg: float):
    """``n_steps`` SGD steps in place on the factors; returns the mean
    batch AUC as a device scalar (no synchronization)."""
    nnz = rows.shape[0]
    n_items = item_factors.shape[0]
    x, y = user_factors, item_factors
    auc_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(n_steps):
        idx, j = _bpr_draw(gen, nnz, n_items, batch_size, x.device)
        u, i = rows[idx], cols[idx]
        ok = ~seen[u, j]
        xu, yi, yj = x[u], y[i], y[j]
        margin = torch.sum(xu * (yi - yj), dim=1)
        g = torch.where(ok, _sigmoid_neg(margin), 0.0)[:, None]
        _bpr_update(x, y, u, i, j, xu, yi, yj, g, ok[:, None].to(x.dtype),
                    lr, reg)
        auc_sum += (ok & (margin > 0)).sum() / ok.sum().clamp(min=1)
    return x, y, auc_sum / n_steps


def _seen_matrix(rows: torch.Tensor, cols: torch.Tensor,
                shape) -> torch.Tensor:
    """Dense (n_users, n_items) bool matrix of the observed pairs."""
    seen = torch.zeros(tuple(int(s) for s in shape), dtype=torch.bool,
                       device=rows.device)
    seen[rows, cols] = True
    return seen


def _bpr_start(shape, rank: int, seed: Optional[int], dtype, device):
    """The BPR generator and starting factors, N(0, 1/rank) each (shared
    by :func:`bpr_train` and the mesh trainer, so both draw alike)."""
    n_users, n_items = (int(s) for s in shape)
    gen = generator_from_seed(seed, device)
    scale = 1.0 / math.sqrt(rank)
    user = torch.randn((n_users, rank), generator=gen, dtype=dtype,
                       device=device) * scale
    item = torch.randn((n_items, rank), generator=gen, dtype=dtype,
                       device=device) * scale
    return gen, user, item


def bpr_train(rows, cols, shape, rank: int,
              learning_rate: float = 0.01, reg: float = 0.01,
              num_epochs: int = 100, batch_size: int = 1024,
              seed: Optional[int] = 0, dtype: torch.dtype = torch.float32,
              verbose: bool = False,
              epoch_stats: Optional[list] = None,
              device=None) -> ImplicitFactors:
    """Bayesian personalized ranking on sampled triples, on ``device``
    (default: the inputs' device for tensors, else the card).  The batch
    AUC of each epoch is appended to ``epoch_stats``, gathered with one
    copy at the end."""
    device = _input_device(device, rows, "bpr_train")
    rows_d = torch.as_tensor(rows).to(device=device, dtype=torch.int64)
    cols_d = torch.as_tensor(cols).to(device=device, dtype=torch.int64)
    seen = _seen_matrix(rows_d, cols_d, shape)
    gen, user_factors, item_factors = _bpr_start(shape, rank, seed, dtype,
                                                 device)
    n_steps = max(1, -(-len(rows_d) // batch_size))
    pending = []
    for epoch in range(num_epochs):
        user_factors, item_factors, auc = _bpr_epoch(
            user_factors, item_factors, seen, rows_d, cols_d, gen,
            n_steps=n_steps, batch_size=batch_size, lr=learning_rate,
            reg=reg)
        if verbose:
            print(f"BPR epoch {epoch + 1}: batch AUC {float(auc):.4f}")
        pending.append(auc)
    if epoch_stats is not None and pending:
        epoch_stats.extend(torch.stack(pending).cpu().double().tolist())
    return ImplicitFactors(user=user_factors, item=item_factors)
