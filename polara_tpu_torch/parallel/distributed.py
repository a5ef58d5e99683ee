"""Training and scoring over a device mesh.

Counterpart of the SVD and dense factor-model parts of
:mod:`polara_tpu.parallel.distributed`.
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

* **iALS** (:func:`distributed_ials`): the confidence block shards by
  users; the item systems are summed from per-shard partials;
* **BPR** (:func:`distributed_bpr`): the batch's gradient math shards,
  or each shard runs its own chain (local SGD);
* **HOOI** (:func:`distributed_hooi`): the tensor's events shard, and
  the per-shard (entity x level x rank) sums are added in shard order;
* **the streaming tier** past the memory budget:
  :func:`distributed_chunked_rsvd` (contiguous row bands of chunked
  events, optionally with a split dense head) and
  :func:`distributed_ials_events` (entities dealt strided onto bands of
  tile-aligned event panels), each band staged on its own device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.ops.rsvd import SvdResult, cholesky_qr2
from polara_tpu_torch.ops.scoring import _merge_candidates
from polara_tpu_torch.ops.sparse import dense_operator
from polara_tpu_torch.ops.topk import (mask_and_topk, mask_and_topk_sharded,
                                       top_k_indices)
from polara_tpu_torch.runtime.mesh import (Mesh, ShardedRows, all_gather,
                                           device_grid, psum, shard_rows,
                                           users_devices)
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


def distributed_ials(dense_ratings: torch.Tensor, rank: int, mesh: Mesh,
                     alpha: float = 1.0, weight="log2",
                     epsilon: float = 1.0, reg: float = 0.01,
                     num_epochs: int = 15, seed: Optional[int] = 0,
                     batch_rows: Optional[int] = 64,
                     dtype: torch.dtype = torch.float32,
                     train_stats: Optional[dict] = None):
    """Confidence-weighted ALS over a row(user)-sharded confidence block.

    One row-sharded copy of the confidence margin ``C - 1`` is resident;
    the item half-sweep assembles its normal systems from per-shard
    partials instead of a transposed copy.  Per epoch:

    * user systems solve shard-locally against the item panel, copied to
      every shard's device (no other traffic);
    * item systems: each shard forms its users' weighted Grams
      ``Σ_u c_ui x_u x_uᵀ`` and right-hand sides ``Σ_u (c_ui+1)·p_ui x_u``;
      the JAX package's ``psum_scatter`` becomes, for each shard's item
      slice, a :func:`~polara_tpu_torch.runtime.mesh.psum` of every
      shard's partials on that shard's device; each slice solves there
      and an :func:`~polara_tpu_torch.runtime.mesh.all_gather` in shard
      order rebuilds the panel on the home device.

    Padding as in the JAX package: users pad to a multiple of the
    ``users`` axis, items to a multiple of ``batch_rows · n_dev`` (zero
    rows and columns solve to zero factors and are sliced off).  The
    start is :func:`ials_train`'s (the same generator draws), so the two
    differ by the order of float sums.  ``train_stats`` receives the
    per-epoch wall seconds and an estimate of the bytes each device
    receives per epoch.
    """
    import time

    from polara_tpu_torch.ops.implicit import (ImplicitFactors,
                                               _auto_batch_rows,
                                               _cholesky_solve,
                                               _initial_item_factors,
                                               _raise_if_failed,
                                               confidence, ials_half_sweep)

    devices = users_devices(mesh)
    n_dev = len(devices)
    home = devices[0]
    n_users, n_items = dense_ratings.shape
    if batch_rows is None:      # sized like the single-device path
        batch_rows = _auto_batch_rows(max(n_users // n_dev, 1), n_items,
                                      rank)
    pad_u = (-n_users) % n_dev
    pad_i = (-n_items) % (batch_rows * n_dev)
    ni_p = n_items + pad_i
    # the padded margin, built in place (one copy of the block)
    cm1 = dense_ratings.new_zeros((n_users + pad_u, ni_p), dtype=dtype)
    cm1[:n_users, :n_items] = confidence(dense_ratings.to(dtype), alpha,
                                         weight, epsilon)
    shards = shard_rows(cm1, mesh).blocks
    del cm1
    eye = reg * torch.eye(rank, dtype=dtype, device=home)
    item_factors = torch.nn.functional.pad(
        _initial_item_factors(n_items, rank, seed, dtype, home),
        (0, 0, 0, pad_i))
    ni_loc = ni_p // n_dev

    def epoch(y):
        failures = []
        x_parts, gram_w, rhs = [], [], []
        for cm1_local, device in zip(shards, devices):
            x_local = ials_half_sweep(cm1_local, y.to(device), reg,
                                      batch_rows)
            rhs.append(torch.where(cm1_local > 0, cm1_local + 1.0, 0.0).T
                       @ x_local)
            parts = []
            for b in range(ni_p // batch_rows):
                cm_b = cm1_local[:, b * batch_rows:(b + 1) * batch_rows]
                weighted = cm_b.T[:, :, None] * x_local[None]  # (b, u, k)
                parts.append(torch.matmul(weighted.transpose(1, 2),
                                          x_local))
            gram_w.append(torch.cat(parts))
            x_parts.append(x_local)
        gram0 = psum([x.T @ x for x in x_parts], home)
        v_parts = []
        for s, device in enumerate(devices):
            rows = slice(s * ni_loc, (s + 1) * ni_loc)
            gram_l = psum([g[rows] for g in gram_w], device)
            rhs_l = psum([r[rows] for r in rhs], device)
            a_l = gram0.to(device)[None] + eye.to(device)[None] + gram_l
            v_parts.append(_cholesky_solve(a_l, rhs_l, failures))
        _raise_if_failed(failures)
        return x_parts, all_gather(v_parts, home)

    itemsize = torch.empty((), dtype=dtype).element_size()
    comm_bytes = int(ni_p * rank * rank * itemsize      # Gram scatter
                     + ni_p * rank * itemsize           # rhs scatter
                     + ni_p * rank * itemsize           # panel gather
                     + rank * rank * itemsize * n_dev)  # gram0 sum
    epochs_log = [] if train_stats is not None else None
    x_parts = []
    for _ in range(num_epochs):
        start = time.perf_counter()
        x_parts, item_factors = epoch(item_factors)
        if epochs_log is not None:
            if item_factors.is_cuda:
                torch.cuda.synchronize(item_factors.device)
            epochs_log.append({"wall_s": time.perf_counter() - start,
                               "comm_bytes": comm_bytes})
    if train_stats is not None:
        train_stats.update(mode="sharded-normal-systems",
                           n_devices=n_dev, epochs=epochs_log)
    user_factors = (all_gather(x_parts, home)[:n_users] if x_parts
                    else torch.zeros((n_users, rank), dtype=dtype,
                                     device=home))
    return ImplicitFactors(user=user_factors, item=item_factors[:n_items])


def distributed_bpr(rows, cols, shape, rank: int, mesh: Mesh,
                    learning_rate: float = 0.01, reg: float = 0.01,
                    num_epochs: int = 100, batch_size: int = 1024,
                    seed: Optional[int] = 0,
                    dtype: torch.dtype = torch.float32,
                    epoch_stats: Optional[list] = None,
                    update_mode: str = "exact",
                    sync_every: Optional[int] = None,
                    train_stats: Optional[dict] = None):
    """BPR over the mesh's ``users`` axis, in one of two modes.

    ``update_mode="exact"``: one sampler draws the single-device
    sampler's batches (:func:`bpr_train`'s generator and starting
    factors); each shard computes the sigmoid gradients of its slice of
    the batch on its own device, the per-triple scalars gather in shard
    order (the JAX package's ``all_gather``), and every device's replica
    of the factors takes the same update.  So the trajectory is
    :func:`bpr_train`'s for the same seed (bit for bit on the CPU).

    ``update_mode="local"``: local SGD.  Each shard runs its own chain on
    ``batch_size / n_dev`` draws per step from a generator seeded by
    (seed, shard), at ``learning_rate · n_dev`` (replica averaging divides
    each chain's progress by ``n_dev``), on its own replica; the replicas
    are averaged (``pmean``) every ``sync_every`` steps (default: once per
    epoch) and at the end of each epoch.  Epoch coverage matches the
    single-device run; the trajectory does not.

    Factors come back on the home device (the first ``users`` shard's).
    ``train_stats`` receives per-epoch wall seconds and an estimate of
    the bytes each device receives.
    """
    import time

    import numpy as np

    from polara_tpu_torch.ops.implicit import (ImplicitFactors, _bpr_draw,
                                               _bpr_epoch, _bpr_start,
                                               _bpr_update, _seen_matrix,
                                               _sigmoid_neg)

    if update_mode not in ("exact", "local"):
        raise ValueError(f"unknown update_mode {update_mode!r}")
    devices = users_devices(mesh)
    n_dev = len(devices)
    home = devices[0]
    if batch_size % n_dev:
        raise ValueError(f"batch_size {batch_size} must divide over "
                         f"{n_dev} devices")
    b_loc = batch_size // n_dev
    n_users, n_items = (int(s) for s in shape)
    rows_h = torch.as_tensor(rows).to(device=home, dtype=torch.int64)
    cols_h = torch.as_tensor(cols).to(device=home, dtype=torch.int64)
    nnz = len(rows_h)
    seen_h = _seen_matrix(rows_h, cols_h, shape)
    gen, user_factors, item_factors = _bpr_start(shape, rank, seed, dtype,
                                                 home)
    # per-device copies of the inputs, one per distinct device
    placed = {d: tuple(t.to(d) for t in (rows_h, cols_h, seen_h))
              for d in dict.fromkeys(devices)}

    n_steps = max(1, -(-nnz // batch_size))
    if sync_every is None:
        sync_every = n_steps
    lr_local = learning_rate * n_dev

    def epoch_exact(x_rep, y_rep):
        auc_sum = torch.zeros((), dtype=torch.float32, device=home)
        for _ in range(n_steps):
            idx, j_all = _bpr_draw(gen, nnz, n_items, batch_size, home)
            g_parts, ok_parts, hits, oks = [], [], [], []
            for s, device in enumerate(devices):
                lo = s * b_loc
                rows_d, cols_d, seen_d = placed[device]
                x, y = x_rep[device], y_rep[device]
                idx_l = idx[lo:lo + b_loc].to(device)
                j_l = j_all[lo:lo + b_loc].to(device)
                u_l, i_l = rows_d[idx_l], cols_d[idx_l]
                ok_l = ~seen_d[u_l, j_l]
                margin_l = torch.sum(x[u_l] * (y[i_l] - y[j_l]), dim=1)
                g_parts.append(torch.where(ok_l, _sigmoid_neg(margin_l),
                                           0.0))
                ok_parts.append(ok_l.to(x.dtype))
                hits.append((ok_l & (margin_l > 0)).sum())
                oks.append(ok_l.sum())
            for device in x_rep:      # every replica takes the same update
                rows_d, cols_d, _ = placed[device]
                x, y = x_rep[device], y_rep[device]
                idx_d, j_d = idx.to(device), j_all.to(device)
                u, i = rows_d[idx_d], cols_d[idx_d]
                _bpr_update(x, y, u, i, j_d, x[u], y[i], y[j_d],
                            all_gather(g_parts, device)[:, None],
                            all_gather(ok_parts, device)[:, None],
                            learning_rate, reg)
            auc_sum += psum(hits, home) / psum(oks, home).clamp(min=1)
        return auc_sum / n_steps

    def chain_generator(shard: int, device) -> torch.Generator:
        """Shard ``shard``'s chain: a generator seeded from (seed, shard)."""
        mixed = np.random.SeedSequence([0 if seed is None else int(seed),
                                        shard])
        gen_s = torch.Generator(device=device)
        gen_s.manual_seed(int(mixed.generate_state(1)[0]))
        return gen_s

    if update_mode == "local":
        chain_gens = [chain_generator(s, d) for s, d in enumerate(devices)]

    def epoch_local(x_rep, y_rep):
        # one replica per shard; the mean of the replicas after each block
        reps = [(x_rep[d].clone(), y_rep[d].clone()) for d in devices]
        aucs = []
        for lo in range(0, n_steps, sync_every):
            steps = min(sync_every, n_steps - lo)
            for s, device in enumerate(devices):
                rows_d, cols_d, seen_d = placed[device]
                x, y = reps[s]
                _, _, auc = _bpr_epoch(x, y, seen_d, rows_d, cols_d,
                                       chain_gens[s], n_steps=steps,
                                       batch_size=b_loc, lr=lr_local,
                                       reg=reg)
                aucs.append((auc * steps).to(home))
            x_mean = psum([x for x, _ in reps], home) / n_dev
            y_mean = psum([y for _, y in reps], home) / n_dev
            reps = [(x_mean.to(d).clone(), y_mean.to(d).clone())
                    for d in devices]
        for d in x_rep:
            x_rep[d], y_rep[d] = x_mean.to(d), y_mean.to(d)
        return torch.stack(aucs).sum() / (n_steps * n_dev)

    itemsize = torch.empty((), dtype=dtype).element_size()
    if update_mode == "local":
        n_blocks = -(-n_steps // sync_every)
        comm_bytes = int(n_blocks * (n_users + n_items) * rank * itemsize)
    else:
        comm_bytes = int(n_steps * 2 * batch_size * itemsize)
    x_rep = {d: user_factors.to(d) for d in placed}
    y_rep = {d: item_factors.to(d) for d in placed}
    run = epoch_local if update_mode == "local" else epoch_exact
    epochs_log = [] if train_stats is not None else None
    pending = []
    for _ in range(num_epochs):
        start = time.perf_counter()
        auc = run(x_rep, y_rep)
        if epochs_log is not None:
            auc = float(auc)
            epochs_log.append({"auc": auc,
                               "wall_s": time.perf_counter() - start,
                               "comm_bytes": comm_bytes})
        pending.append(torch.as_tensor(auc, dtype=torch.float32,
                                       device=home))
    if epoch_stats is not None and pending:
        epoch_stats.extend(torch.stack(pending).cpu().double().tolist())
    if train_stats is not None:
        train_stats.update(mode=update_mode, n_devices=n_dev,
                           steps_per_epoch=n_steps, epochs=epochs_log)
    return ImplicitFactors(user=x_rep[home], item=y_rep[home])


def distributed_hooi(idx: np.ndarray, val: np.ndarray, shape, core_shape,
                     mesh: Mesh, num_iters: int = 25,
                     growth_tol: float = 1e-4, seed: Optional[int] = None,
                     dtype: torch.dtype = torch.float32,
                     verbose: bool = False,
                     qr_method: Optional[str] = None,
                     init_factors: Optional[Tuple] = None):
    """HOOI with the tensor's events (numpy ``idx`` (nnz, 3) and ``val``)
    split over the mesh's first axis.

    The events pad with zero values to a multiple of the axis and split
    into equal contiguous shards, each staged on its shard's device in
    the sweep's two orders.  Each sweep, every shard forms its partial
    (n_mode x n_fb x r) sums from its own events (the O(nnz·r) work) and
    the partials are added on the home device in shard order, so two runs
    give the same bits; the skinny factor updates, which the JAX package
    replicates on every device, run once there.  Padding events add zero
    terms, so the split changes the math only by the order of float sums.
    The start is :func:`~polara_tpu_torch.ops.hooi.hooi`'s (the same
    generator draws, on the home device)."""
    from polara_tpu_torch.ops.hooi import (_entity_feedback_sums,
                                           _hooi_until, check_core_shape,
                                           initial_factors,
                                           stage_hooi_events)
    from polara_tpu_torch.ops.rsvd import _qr_method

    devices = users_devices(mesh)
    home = devices[0]
    shape = tuple(int(s) for s in shape)
    core_shape = tuple(int(r) for r in core_shape)
    check_core_shape(shape, core_shape)
    n0, _, n2 = shape
    u1, u2 = initial_factors(shape, core_shape, seed, dtype, home,
                             init_factors)
    u0 = torch.zeros((n0, core_shape[0]), dtype=dtype, device=home)

    idx = np.asarray(idx)
    val = np.asarray(val, np.float64)
    pad = (-len(val)) % len(devices)
    idx = np.concatenate([idx, np.zeros((pad, idx.shape[1]), idx.dtype)])
    val = np.concatenate([val, np.zeros(pad)])
    per = len(val) // len(devices)
    staged = [stage_hooi_events(idx[i * per:(i + 1) * per],
                                val[i * per:(i + 1) * per], shape, dtype,
                                device)
              for i, device in enumerate(devices)]

    def sums(side, factor):
        return psum([_entity_feedback_sums(sides[side], factor.to(device),
                                           n2)
                     for sides, device in zip(staged, devices)], home)

    return _hooi_until(sums, u0, u1, u2, shape, core_shape, num_iters,
                       float(growth_tol), _qr_method(qr_method),
                       verbose=verbose, label="distributed HOOI")


# --------------------------------------------------------------------------
# the event-sharded streaming tier
# --------------------------------------------------------------------------

class _Band(NamedTuple):
    """One users-axis shard's contiguous row band, staged on its device:
    the chunked row-sorted side (``mm``), the column-sorted side
    (``rmm``), and the band's slice of the split head (None without one).
    A side is None when the band holds no tail events."""
    device: torch.device
    row_side: object
    col_side: object
    head: Optional[torch.Tensor]


def _band_passes(band: _Band, m_band: int, n: int, head_ids=None):
    """One band's ``A @ x`` (its (m_band, b) rows) and local ``Aᵀ @ y``
    (the band's (n, b) partial, which the caller sums over bands): the
    chunked streaming passes over the band's events plus, with a split
    head, the band's dense head rows."""
    from polara_tpu_torch.ops.sparse import (_head_mm_blocks,
                                             _head_rmm_blocks,
                                             _stream_pass)
    ids = None if head_ids is None else head_ids.to(band.device)

    def mm(x):
        x = x.to(band.device)
        out = _stream_pass(band.row_side, x, m_band)
        if band.head is not None:
            out = out + _head_mm_blocks(band.head, ids, x, m_band)
        return out

    def rmm_local(y):
        out = _stream_pass(band.col_side, y, n)
        if band.head is not None:
            # tail events never reference head columns: disjoint writes
            out[ids] = out[ids] + _head_rmm_blocks(band.head, y)
        return out

    return mm, rmm_local


def _rsvd_power_psum(mm, rmm, omega: torch.Tensor, n_iter: int, k: int,
                     tol: Optional[float], max_iter: int):
    """The power iteration of the distributed rSVD: the tall (user-side)
    panel is row-sharded and orthogonalized by CholeskyQR2 over a psum'd
    b x b Gram; the item-side panel is whole on the home device.  Without
    ``tol``, ``n_iter`` iterations; with it, until the top-k singular
    estimates are relatively stable below ``tol`` (at most ``max_iter``),
    the single-device stopping rule.  Returns ``(u, s, v)`` with ``u``
    gathered, padding rows dropped."""
    q, _ = cholesky_qr2(mm(omega))
    if tol is None:
        for _ in range(n_iter):
            z, _ = cholesky_qr2(rmm(q))
            q, _ = cholesky_qr2(mm(z))
    else:
        s_prev = torch.full((k,), torch.inf, dtype=omega.dtype,
                            device=omega.device)
        for _ in range(max_iter):
            z, rz = cholesky_qr2(rmm(q))
            s_top = torch.abs(torch.diagonal(rz))[:k]
            q, _ = cholesky_qr2(mm(z))
            rel = torch.max(torch.abs(s_top - s_prev)
                            / torch.clamp(torch.abs(s_top), min=1e-30))
            s_prev = s_top
            if bool(rel < tol):
                break
    b_mat = rmm(q).T                     # (blk, n)
    ub, s, vt = torch.linalg.svd(b_mat, full_matrices=False)
    return (q @ ub).gather()[:, :k], s[:k], vt[:k, :].T


def _chunked_rsvd_local(bands: List[_Band], omega: torch.Tensor,
                        n_rows: int, m_band: int, n_iter: int, k: int,
                        tol: Optional[float] = None, max_iter: int = 100,
                        head_ids: Optional[torch.Tensor] = None):
    """The body of :func:`distributed_chunked_rsvd` over its bands (the
    JAX package's per-device ``shard_map`` body, here a loop over bands,
    each on its own device):

    * ``A @ x``: each band's local product, kept as its shard of a
      :class:`ShardedRows` panel (no traffic);
    * ``Aᵀ @ y``: each band's local column reduction of its shard, summed
      in band order on the home device (one (n x b) ``psum``).

    With ``head_ids`` the bands carry split heads (the JAX package's
    ``_split_rsvd_local``: int8 when lossless, upcast one row block at a
    time); the head adds no collective."""
    home = omega.device
    n = omega.shape[0]
    passes = [_band_passes(band, m_band, n, head_ids) for band in bands]

    def mm(x):
        return ShardedRows(tuple(p[0](x) for p in passes), n_rows)

    def rmm(y):
        return psum([p[1](block) for p, block in zip(passes, y.blocks)],
                    home)

    return _rsvd_power_psum(mm, rmm, omega, n_iter, k, tol, max_iter)


def distributed_chunked_rsvd(rows, cols, vals, shape, k: int, mesh: Mesh,
                             oversample: Optional[int] = None,
                             n_iter: int = 6, seed: int = 0,
                             event_chunk: int = 1_000_000,
                             tol: Optional[float] = None,
                             max_iter: int = 100,
                             dtype: torch.dtype = torch.float32,
                             split_head: bool = False,
                             head_items="auto",
                             head_budget_gb: Optional[float] = 4.0,
                             head_block_rows: int = 4096,
                             min_coverage: float = 0.15) -> SvdResult:
    """Randomized SVD of a beyond-budget sparse matrix with its events
    sharded over the mesh's ``users`` axis (counterpart of the JAX
    package's ``distributed_chunked_rsvd``).

    The row range splits into contiguous bands of ``ceil(m / n_shards)``
    rows, one per users shard.  Each band's events are staged from the
    event tensors on the band's own device in the chunked layout
    (:func:`~polara_tpu_torch.ops.sparse.chunked_coo_operator`'s: a
    row-sorted side for ``A @ x`` and a column-sorted side for its local
    ``Aᵀ @ y``, both chunks of ``event_chunk``), so a device holds about
    nnz / n_shards events plus one (event_chunk, block) panel.  The
    subspace iteration is the single-device one with
    ``qr_method="cholesky2"``: the same random start (the generator of
    ``seed`` on the home device), the same steps, other float order.
    ``tol`` turns on the single-device stopping rule; the block never
    escalates (fixed at ``k + oversample``).

    ``split_head``: the P most-rated items' events go into a dense head,
    each band holding its rows (:func:`_stage_split_head`), with the rest
    in the bands' chunked tails; ``head_budget_gb`` None derives the
    budget from the home device's free memory
    (:func:`~polara_tpu_torch.ops.sparse.resolve_head_budget`).

    ``rows``/``cols``/``vals``: numpy arrays or tensors (moved once to
    the home device, sorted there by row when they are not)."""
    from polara_tpu_torch.ops.sparse import (_events_on_device,
                                             _stage_chunked_side)

    devices = users_devices(mesh)
    home = devices[0]
    n_dev = len(devices)
    if len(vals) == 0:
        raise ValueError("empty matrix")
    rows, cols, vals = _events_on_device(rows, cols, vals, dtype, home,
                                         "distributed_chunked_rsvd")
    m, n = (int(s) for s in shape)
    if k <= 0 or k > min(m, n):
        raise ValueError(f"rank {k} out of range for shape {(m, n)}")
    blk = min(k + (oversample if oversample is not None else max(10, k)),
              min(m, n))
    m_band = -(-m // n_dev)

    head = None
    if split_head:
        head = _stage_split_head(rows, cols, vals, m, n, devices, m_band,
                                 head_items, head_budget_gb,
                                 head_block_rows, min_coverage, dtype)
    head_ids, heads = None, [None] * n_dev
    if head is not None:
        heads, head_ids, tail = head
        rows, cols, vals = rows[tail], cols[tail], vals[tail]

    bounds = torch.searchsorted(
        rows, torch.arange(n_dev + 1, device=home) * m_band).tolist()
    bands = []
    for b, device in enumerate(devices):
        lo, hi = bounds[b], bounds[b + 1]
        row_side = col_side = None
        if hi > lo:
            r = (rows[lo:hi] - b * m_band).to(device)
            c, v = cols[lo:hi].to(device), vals[lo:hi].to(device)
            corder = torch.argsort(c, stable=True)
            row_side = _stage_chunked_side(r, c, v, event_chunk)
            col_side = _stage_chunked_side(c[corder], r[corder], v[corder],
                                           event_chunk)
        bands.append(_Band(device, row_side, col_side, heads[b]))
    del rows, cols, vals

    gen = generator_from_seed(seed, home)
    omega = torch.randn((n, blk), generator=gen, dtype=dtype, device=home)
    common = dict(n_rows=m, m_band=m_band, n_iter=n_iter, k=k,
                  tol=None if tol is None else float(tol),
                  max_iter=max_iter)
    u, s, v = _chunked_rsvd_local(bands, omega, head_ids=head_ids,
                                  **common)
    return SvdResult(u=u, s=s, v=v)


def _stage_split_head(rows, cols, vals, m: int, n: int, devices,
                      m_band: int, head_items, head_budget_gb,
                      head_block_rows: int, min_coverage: float,
                      dtype: torch.dtype):
    """Head selection and the banded head blocks of the split-head mesh
    tier, by the single-device operator's rules
    (:func:`~polara_tpu_torch.ops.sparse.split_coo_operator`): P from the
    budget, rounded to 128, declined below ``min_coverage``; the top
    counts with ties to the lower id (the JAX package's ``argpartition``
    leaves ties unordered; any head gives the same products).  Each band
    builds its rows' ``(nb_local, block_rows, P)`` head on its own device;
    when one band's cells overflow int8, every band keeps ``dtype``.
    Returns ``(heads, head_ids, tail_mask)`` or None when the head
    declines."""
    from polara_tpu_torch.ops.sparse import (_top_items, build_head_block,
                                             resolve_head_budget)

    home = rows.device
    nnz = rows.shape[0]
    budget = resolve_head_budget(head_budget_gb, home)
    int8_ok = bool(((vals == torch.round(vals)) & (vals.abs() <= 127)).all())
    itemsize = 1 if int8_ok else torch.empty((), dtype=dtype).element_size()
    if head_items == "auto":
        p = int(budget * 2 ** 30) // (m * itemsize)
    else:
        p = int(head_items)
    p = min(p, n)
    if p >= 128:
        p = (p // 128) * 128
    if p < 1:
        return None
    if p < n:
        counts = torch.bincount(cols, minlength=n)
        head_ids = _top_items(counts, p)
        if float(counts[head_ids].sum()) / nnz < min_coverage:
            return None
        is_head = torch.zeros(n, dtype=torch.bool, device=home)
        is_head[head_ids] = True
        mask = is_head[cols]
    else:
        head_ids = torch.arange(n, device=home)
        mask = torch.ones(nnz, dtype=torch.bool, device=home)
    head_pos = torch.zeros(n, dtype=torch.int64, device=home)
    head_pos[head_ids] = torch.arange(p, device=home)
    hr, hc, hv = rows[mask], cols[mask], vals[mask]
    br = min(head_block_rows, m_band)
    nb_local = -(-m_band // br)
    bounds = torch.searchsorted(
        hr, torch.arange(len(devices) + 1, device=home) * m_band).tolist()
    heads = []
    for b, device in enumerate(devices):
        lo, hi = bounds[b], bounds[b + 1]
        heads.append(build_head_block(
            (hr[lo:hi] - b * m_band).to(device),
            head_pos[hc[lo:hi]].to(device), hv[lo:hi].to(device),
            nb_local * br, p, dtype, head_budget_gb=budget,
            int8_ok=int8_ok).view(nb_local, br, p))
    if any(h.dtype != torch.int8 for h in heads):
        heads = [h.to(dtype) for h in heads]
    return heads, head_ids, ~mask


def distributed_ials_events(rows, cols, vals, shape, rank: int, mesh: Mesh,
                            alpha: float = 1.0, weight="log2",
                            epsilon: float = 1.0, reg: float = 0.01,
                            num_epochs: int = 15, seed: Optional[int] = 0,
                            tile: int = 128, batch_entities: int = 4096,
                            max_window_events: int = 4_000_000,
                            dtype: torch.dtype = torch.float32,
                            train_stats: Optional[dict] = None):
    """Streaming (beyond-budget) iALS with the event stream sharded over
    the mesh's ``users`` axis: the mesh tier of
    :func:`~polara_tpu_torch.ops.implicit.ials_train_events`.

    Entities deal onto shards strided (entity ``g`` -> shard
    ``g % n_shards``, local id ``g // n_shards``), so Zipf-skewed event
    counts balance instead of piling the popular head onto one band.  Each
    shard stages only its own bands' tile-aligned panels for both sweep
    sides, on its own device (about ``2·nnz / n_shards`` events each); a
    band with no events runs on one zero-weight placeholder event.  A
    half-sweep solves each band's systems against the whole other-side
    panel (:func:`~polara_tpu_torch.ops.implicit._ell_half_sweep`), and
    the bands' factors gather on the home device in natural order: two
    panel gathers per epoch, bytes independent of nnz.  With one process
    driving the mesh, each band keeps its own staging geometry (the JAX
    package forces one common geometry for ``shard_map``).

    Same start and sweep order as the single-device event tier, so the
    two differ by the order of float sums.  ``train_stats`` receives the
    per-epoch wall seconds and the bytes each device receives."""
    import time

    from polara_tpu_torch.ops.implicit import (ImplicitFactors,
                                               _ell_half_sweep,
                                               _initial_item_factors,
                                               canonical_weight, confidence,
                                               stage_events_side)
    from polara_tpu_torch.ops.sparse import _events_on_device

    devices = users_devices(mesh)
    home = devices[0]
    n_dev = len(devices)
    n_users, n_items = (int(s) for s in shape)
    if len(vals) == 0:
        raise ValueError("empty matrix")
    weight = canonical_weight(weight)
    rows_d, cols_d, vals_d = _events_on_device(
        rows, cols, vals, dtype, home, "distributed_ials_events",
        assume_sorted=True)
    cm1 = confidence(vals_d, alpha, weight, epsilon)

    nl_u = -(-n_users // n_dev)
    nl_i = -(-n_items // n_dev)
    nu_pad, ni_pad = nl_u * n_dev, nl_i * n_dev

    def stage_banded(maj, minor, w, n_local):
        be = min(batch_entities, n_local)
        order = torch.argsort(maj, stable=True)
        maj, minor, w = maj[order], minor[order], w[order]
        band = maj % n_dev
        sides = []
        for b, device in enumerate(devices):
            sel = band == b
            mb, nb, wb = maj[sel] // n_dev, minor[sel], w[sel]
            if mb.shape[0] == 0:
                # zero-weight placeholder: a zero margin adds nothing to
                # the Gram or the right-hand side
                mb, nb = mb.new_zeros(1), nb.new_zeros(1)
                wb = wb.new_zeros(1)
            sides.append(stage_events_side(
                mb.to(device), nb.to(device), wb.to(device), n_local,
                tile=tile, batch_entities=be,
                max_window_events=max_window_events))
        return sides

    u_sides = stage_banded(rows_d, cols_d, cm1, nl_u)
    i_sides = stage_banded(cols_d, rows_d, cm1, nl_i)
    del rows_d, cols_d, vals_d, cm1

    def natural(parts, n_pad):
        # shard b's local row l is entity l * n_dev + b
        k = parts[0].shape[1]
        return (all_gather(parts, home).view(n_dev, -1, k)
                .transpose(0, 1).reshape(n_pad, k))

    def half(sides, other, n_pad):
        return natural([_ell_half_sweep(
            side.minor, side.w, side.starts, side.ent_starts, side.n_ents,
            side.owner_local, other.to(device), reg,
            n_entities=side.n_entities, batch_entities=side.batch_entities,
            tile=side.tile) for side, device in zip(sides, devices)], n_pad)

    item_factors = torch.nn.functional.pad(
        _initial_item_factors(n_items, rank, seed, dtype, home),
        (0, 0, 0, ni_pad - n_items))
    user_factors = torch.zeros((nu_pad, rank), dtype=dtype, device=home)
    itemsize = torch.empty((), dtype=dtype).element_size()
    comm_bytes = (nu_pad + ni_pad) * rank * itemsize    # 2 panel gathers
    epochs_log = [] if train_stats is not None else None
    for _ in range(num_epochs):
        start = time.perf_counter()
        user_factors = half(u_sides, item_factors, nu_pad)
        item_factors = half(i_sides, user_factors, ni_pad)
        if epochs_log is not None:
            if item_factors.is_cuda:
                torch.cuda.synchronize(item_factors.device)
            epochs_log.append({"wall_s": time.perf_counter() - start,
                               "comm_bytes": comm_bytes})
    if train_stats is not None:
        train_stats.update(mode="sharded-event-streams", n_devices=n_dev,
                           epochs=epochs_log)
    return ImplicitFactors(user=user_factors[:n_users],
                           item=item_factors[:n_items])
