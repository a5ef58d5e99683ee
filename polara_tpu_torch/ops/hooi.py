"""Sparse third-order Tucker decomposition by HOOI.

Counterpart of :mod:`polara_tpu.ops.hooi` (which replaces the reference's
Numba ttm kernels and ARPACK loop, ``polara/lib/tensor.py:37-96``).  The
feedback mode is tiny (a handful of rating levels), so every mode's ttm
unfolding comes from one sum over the joint (entity, level) key,

    A[e, f, :] = sum over events (e, ·, f) of val · U[other entity, :],

and a small product of ``A`` with the feedback factor.  The sums run as
sorted segment sums (:func:`~polara_tpu_torch.ops.sparse.sorted_rows_matmul`)
over the events staged once per build in two orders, by (user, level) and
by (item, level): each output row is summed in a fixed order, so two
builds give the same bits on the card, where ``index_add_``'s atomics do
not.  Left singular vectors of the tall unfoldings come from a tall-skinny
QR (Householder, or CholeskyQR2) and an SVD of the small R factor.

Three tiers share one sweep (:func:`_hooi_sweep`), which takes the sums
as a function: the event tier (:func:`stage_hooi_events`), the dense tier
(the tensor fits ``dense_budget_bytes``; plain products over the dense
block) and the mesh trainer's per-shard partial sums
(:func:`polara_tpu_torch.parallel.distributed.distributed_hooi`).  The
convergence loop is eager: it reads the core norm on the host once per
sweep for the stopping test.  The random start comes from a
``torch.Generator``, a different stream from ``jax.random``; pass
``init_factors`` to start both packages from the same panels.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.ops.rsvd import _qr_method, cholesky_qr2
from polara_tpu_torch.ops.sparse import dense_from_coo, sorted_rows_matmul
from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.rng import generator_from_seed

ArrayLike = Union[np.ndarray, torch.Tensor]
# sums(side, factor) -> (n_side, n_fb, r): side 0 sums the rows of the
# item factor by (user, level), side 1 the rows of the user factor by
# (item, level)
SumsFn = Callable[[int, torch.Tensor], torch.Tensor]


class HooiResult(NamedTuple):
    u0: torch.Tensor     # users    (n0, r0)
    u1: torch.Tensor     # items    (n1, r1)
    u2: torch.Tensor     # feedback (n2, r2)
    core: torch.Tensor   # (r0, r1, r2)
    growth_history: tuple


class EntityEvents(NamedTuple):
    """The events of one side sorted by the joint key ``entity · n_fb +
    level`` (stable, so ties keep their input order): ``other`` indexes
    the factor whose rows are summed, ``lengths`` counts the events of
    each key."""
    other: torch.Tensor     # (nnz,) int64
    vals: torch.Tensor      # (nnz,)
    lengths: torch.Tensor   # (n_entity * n_fb,) int64
    n_entity: int


def stage_entity_events(entity: torch.Tensor, fb: torch.Tensor,
                        other: torch.Tensor, vals: torch.Tensor,
                        n_entity: int, n_fb: int) -> EntityEvents:
    """Sort the events by (entity, level) once, for every sweep."""
    joint = entity * n_fb + fb
    order = torch.argsort(joint, stable=True)
    return EntityEvents(other[order], vals[order],
                        torch.bincount(joint, minlength=n_entity * n_fb),
                        n_entity)


def _entity_feedback_sums(events: EntityEvents, factor: torch.Tensor,
                          n_fb: int) -> torch.Tensor:
    """``A[e, f, :] = Σ val · factor[other]`` over the events of each
    (entity, level) key: one gather and one sorted segment sum."""
    flat = sorted_rows_matmul(None, events.other, events.vals, factor,
                              events.n_entity * n_fb, events.lengths)
    return flat.reshape(events.n_entity, n_fb, factor.shape[1])


def stage_hooi_events(idx: ArrayLike, val: ArrayLike,
                      shape: Tuple[int, int, int], dtype: torch.dtype,
                      device: torch.device
                      ) -> Tuple[EntityEvents, EntityEvents]:
    """The (nnz, 3) COO events on ``device`` in the two orders the sweep
    reads: by (user, level) and by (item, level)."""
    n0, n1, n2 = shape
    idx = torch.as_tensor(idx).to(device=device, dtype=torch.int64)
    vals = torch.as_tensor(val).to(device=device, dtype=dtype)
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    return (stage_entity_events(i0, i2, i1, vals, n0, n2),
            stage_entity_events(i1, i2, i0, vals, n1, n2))


def event_sums(by_user: EntityEvents, by_item: EntityEvents,
               n_fb: int) -> SumsFn:
    """The sweep's sums over staged events."""
    sides = (by_user, by_item)
    return lambda side, factor: _entity_feedback_sums(sides[side], factor,
                                                      n_fb)


def dense_sums(d: torch.Tensor) -> SumsFn:
    """The sweep's sums over the dense (users, items, levels) block."""
    def sums(side, factor):
        if side == 0:
            return torch.einsum("uif,ir->ufr", d, factor)
        return torch.einsum("uif,ur->ifr", d, factor)
    return sums


def _left_singular_vectors(m: torch.Tensor, k: int,
                           qr_method: str = "householder"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k left singular vectors of a tall-skinny matrix (QR + small
    SVD); returns (U_k, all singular values)."""
    if qr_method == "cholesky2":
        # relative jitter guards the Gram against rank-deficient
        # unfoldings (meaningful in f32, unlike an absolute epsilon)
        q, r = cholesky_qr2(m, eps=1e-6)
    else:
        q, r = torch.linalg.qr(m)
    ur, s, _ = torch.linalg.svd(r)
    return q @ ur[:, :k], s


def _hooi_sweep(sums: SumsFn, u0: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor, shape: Tuple[int, int, int],
                core_shape: Tuple[int, int, int],
                qr_method: str = "householder"):
    """One HOOI sweep: the three mode updates in turn, then the core."""
    n0, n1, n2 = shape
    r0, r1, r2 = core_shape

    # mode 0: unfold = A x2 u2, A[u, f, :] = Σ val · u1[item]
    a = sums(0, u1)
    m0 = torch.einsum("ufa,fs->uas", a, u2).reshape(n0, -1)
    u0, _ = _left_singular_vectors(m0, r0, qr_method)

    # mode 1 with the refreshed u0
    b = sums(1, u0)
    m1 = torch.einsum("ifb,fs->ibs", b, u2).reshape(n1, -1)
    u1, _ = _left_singular_vectors(m1, r1, qr_method)

    # mode 2 with the refreshed u0, u1; also yields the core
    a2 = sums(0, u1)
    m2 = torch.einsum("ufa,ub->fab", a2, u0).reshape(n2, -1)
    uu, s, _ = torch.linalg.svd(m2, full_matrices=False)   # n2 is tiny
    u2 = uu[:, :r2]
    core_norm = torch.linalg.norm(s[:r2])
    core = torch.einsum("ua,ufb,fc->abc", u0, a2, u2)
    return u0, u1, u2, core, core_norm


def _hooi_until(sums: SumsFn, u0, u1, u2, shape, core_shape,
                num_iters: int, growth_tol: float, qr_method: str,
                verbose: bool = False, label: str = "HOOI") -> HooiResult:
    """Sweeps until the core norm's relative growth, computed in the
    factors' dtype, falls below ``growth_tol`` (or ``num_iters`` sweeps):
    one host read of the growth per sweep."""
    core = torch.zeros(core_shape, dtype=u1.dtype, device=u1.device)
    norm_old = torch.zeros((), dtype=u1.dtype, device=u1.device)
    history = []
    for step in range(num_iters):
        u0, u1, u2, core, core_norm = _hooi_sweep(
            sums, u0, u1, u2, shape, core_shape, qr_method)
        growth = float((core_norm - norm_old) / core_norm)
        norm_old = core_norm
        history.append(growth)
        if verbose:
            print(f"{label} step {step + 1}: core growth {growth:.6f}")
        if growth < growth_tol:
            break
    return HooiResult(u0=u0, u1=u1, u2=u2, core=core,
                      growth_history=tuple(history))


def initial_factors(shape: Tuple[int, int, int],
                    core_shape: Tuple[int, int, int],
                    seed: Optional[int], dtype: torch.dtype,
                    device: torch.device,
                    init_factors: Optional[Tuple] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (u1, u2) start: ``init_factors`` checked against the modes, or
    the QR of uniform draws from a generator seeded with ``seed``."""
    _, n1, n2 = shape
    _, r1, r2 = core_shape
    if init_factors is not None:
        u1, u2 = (torch.as_tensor(np.array(f)).to(device=device,
                                                     dtype=dtype)
                  for f in init_factors)
        if u1.shape != (n1, r1) or u2.shape != (n2, r2):
            raise ValueError(f"init factors {tuple(u1.shape)}/"
                             f"{tuple(u2.shape)} do not match modes "
                             f"{(n1, r1)}/{(n2, r2)}")
        return u1, u2
    gen = generator_from_seed(seed, device)
    u1 = torch.linalg.qr(torch.rand((n1, r1), generator=gen, dtype=dtype,
                                    device=device))[0]
    u2 = torch.linalg.qr(torch.rand((n2, r2), generator=gen, dtype=dtype,
                                    device=device))[0]
    return u1, u2


def check_core_shape(shape: Tuple[int, int, int],
                     core_shape: Tuple[int, int, int]) -> None:
    if not all(r <= n for r, n in zip(core_shape, shape)):
        raise ValueError(f"core shape {tuple(core_shape)} exceeds tensor "
                         f"{tuple(shape)}")


def hooi(idx: ArrayLike, val: ArrayLike, shape: Tuple[int, int, int],
         core_shape: Tuple[int, int, int], num_iters: int = 25,
         growth_tol: float = 1e-4, seed: Optional[int] = None,
         dtype: torch.dtype = torch.float32, verbose: bool = False,
         qr_method: Optional[str] = None,
         dense_budget_bytes: Optional[int] = None,
         dense_tensor: Optional[torch.Tensor] = None,
         init_factors: Optional[Tuple] = None,
         device: Union[str, torch.device, None] = None) -> HooiResult:
    """HOOI with a QR-random start and the core-growth stopping test
    (reference ``tensor.py:57-88``): stop when the relative growth of the
    core norm falls below ``growth_tol``.

    ``idx`` (nnz, 3) and ``val`` are the tensor's events (numpy or
    tensors).  The dense tier runs when ``dense_tensor`` is given or the
    tensor fits ``dense_budget_bytes``, the event tier otherwise; with
    ``verbose`` the growth of each sweep is printed and the event tier
    runs, as in the JAX package.  ``init_factors``: optional ``(u1, u2)``
    orthonormal panels to start from instead of the seeded draw.
    ``device``: default that of ``dense_tensor`` or of a tensor ``idx``,
    else the card.  ``qr_method``: ``"householder"`` (default) or
    ``"cholesky2"``.
    """
    qr_method = _qr_method(qr_method)
    if device is None and dense_tensor is not None:
        device = dense_tensor.device
    elif device is None and isinstance(idx, torch.Tensor):
        device = idx.device
    device = resolve_device(device, "hooi")
    shape = tuple(int(s) for s in shape)
    core_shape = tuple(int(r) for r in core_shape)
    check_core_shape(shape, core_shape)
    n0, n1, n2 = shape
    u1, u2 = initial_factors(shape, core_shape, seed, dtype, device,
                             init_factors)
    u0 = torch.zeros((n0, core_shape[0]), dtype=dtype, device=device)

    itemsize = torch.empty((), dtype=dtype).element_size()
    use_dense = not verbose and (dense_tensor is not None or (
        dense_budget_bytes is not None
        and n0 * n1 * n2 * itemsize <= dense_budget_bytes))
    if use_dense:
        d = dense_tensor
        if d is None:
            d = dense_from_coo(np.asarray(idx),
                               np.asarray(val, np.float64), shape,
                               dtype=dtype, device=device)
        sums = dense_sums(d)
    else:
        sums = event_sums(*stage_hooi_events(idx, val, shape, dtype, device),
                          n2)
    return _hooi_until(sums, u0, u1, u2, shape, core_shape, num_iters,
                       float(growth_tol), qr_method, verbose=verbose)


def round_core(core: np.ndarray, mode: int, rank: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Truncate one mode of the Tucker core via SVD of its unfolding
    (reference ``models.py:970-980``) — evaluates smaller mlranks without
    re-running HOOI.  Returns (rotation, new_core); the mode's factor is
    updated as ``factor @ rotation``.  Host-side numpy: the core is tiny.
    """
    core = np.asarray(core)
    lead = [mode] + [m for m in range(core.ndim) if m != mode]
    flat = core.transpose(lead).reshape(core.shape[mode], -1, order="F")
    u, s, vt = np.linalg.svd(flat, full_matrices=False)
    rotation = u[:, :rank]
    rest_dims = [core.shape[m] for m in lead[1:]]
    inverse = np.argsort(lead)
    new_core = (s[:rank, None] * vt[:rank])\
        .reshape([rank] + rest_dims, order="F").transpose(inverse)
    return rotation, np.ascontiguousarray(new_core)


def flatten_feedback_weights(w, flattener) -> np.ndarray:
    """Collapse the feedback factor into a rank-r2 weighting vector used by
    the scoring path (reference ``flatten_scores``, ``models.py:983-1006``,
    applied to ``w.T`` at ``models.py:1052``).

    The flattener decides how predicted scores across rating levels merge
    into one relevance score per item (the polarity trick: summing over all
    levels weights items by how confidently the model puts them in *high*
    ratings).
    """
    wt = np.asarray(w).T               # (r2, n_fb)
    if flattener is None:
        flattener = slice(None)
    if isinstance(flattener, str):
        return getattr(np, flattener)(wt, axis=-1)
    if isinstance(flattener, (int, np.integer)):
        return wt[..., flattener]
    if isinstance(flattener, (list, slice)):
        return wt[..., flattener].sum(axis=-1)
    if isinstance(flattener, tuple):
        slicer, method = flattener
        slicer = slice(None) if slicer is None else slicer
        return getattr(np, method)(wt[..., slicer], axis=-1)
    if callable(flattener):
        return np.asarray(flattener(wt))
    raise ValueError("Unrecognized flattener value")


def tucker_als(idx, val, shape, mlrank, *args, **kwargs):
    """Legacy alias for :func:`hooi` (the reference keeps a duplicate
    implementation in ``polara/lib/hosvd.py:27-89``)."""
    return hooi(idx, val, shape, mlrank, *args, **kwargs)
