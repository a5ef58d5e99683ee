"""Truncated SVD via randomized subspace iteration.

Counterpart of :mod:`polara_tpu.ops.rsvd` (itself the replacement of the
reference's ARPACK call, ``polara/recommender/models.py:844``): k-wide
panel products through any :class:`MatmulOperator`, tall-skinny QR
re-orthogonalization, and a final Rayleigh–Ritz projection.  PyTorch runs
eagerly, so each stage is plain tensor code; the dense products go to
cuBLAS and the small factorizations to cuSOLVER on CUDA.

:func:`randomized_svd_krylov` is the block-Krylov alternative.

Convention parity: singular values descending, factors ``(u, s, v)`` with
``v`` of shape (n, k).  The random start comes from a ``torch.Generator``,
a different stream from the JAX package's, so factors agree with it in
singular values and subspaces, never as arrays.

Panel QR is Householder (``torch.linalg.qr``) unless the caller asks for
``qr_method="cholesky2"``.  Over a row-sharded operator (a
:class:`~polara_tpu_torch.runtime.mesh.ShardedRows` dense block) the tall
panels are sharded too and only CholeskyQR2 applies: its Gram is a
``psum`` of the shards' local Grams and each shard solves its own rows.
The replicated (n-side) panels live on the home device, and ``u`` comes
back gathered there with the padding rows dropped.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from polara_tpu_torch.ops.sparse import MatmulOperator, dense_operator
from polara_tpu_torch.runtime.mesh import ShardedRows, psum
from polara_tpu_torch.runtime.rng import generator_from_seed

Panel = Union[torch.Tensor, ShardedRows]
QR_METHODS = ("householder", "cholesky2")


class SvdResult(NamedTuple):
    u: torch.Tensor        # (m, k)
    s: torch.Tensor        # (k,) descending
    v: torch.Tensor        # (n, k)


def _as_operator(a: Union[torch.Tensor, MatmulOperator]) -> MatmulOperator:
    if isinstance(a, MatmulOperator):
        return a
    return dense_operator(a)


def _operator_device(op: MatmulOperator) -> torch.device:
    return op.device


def cholesky_qr2(y: Panel, eps: float = 0.0) -> Tuple[Panel, torch.Tensor]:
    """Tall-skinny QR via two rounds of Gram -> Cholesky -> triangular
    solve (CholeskyQR2, Fukaya et al.): the only large product is the
    (b x b) Gram.  It squares the panel's condition number; a Gram that
    is not positive definite raises (``torch.linalg.LinAlgError``).
    ``eps`` adds a diagonal jitter relative to the Gram's mean diagonal
    (an absolute one is a no-op in f32 once the diagonal is large), for
    nearly rank-deficient panels.

    ``y`` may be a :class:`ShardedRows` panel: the Gram is the ``psum`` of
    the shards' local Grams (one b x b matrix per pass), the factor ``r``
    lives on the home device, and each shard solves its own rows."""
    def one_pass(a):
        if isinstance(a, ShardedRows):
            gram = psum([block.T @ block for block in a.blocks], a.device)
        else:
            gram = a.T @ a
        if eps:
            scale = torch.trace(gram) / gram.shape[0]
            gram = gram + (eps * scale) * torch.eye(
                gram.shape[0], dtype=gram.dtype, device=gram.device)
        r = torch.linalg.cholesky(gram).T          # upper triangular

        def solve(block):
            # q = a r^{-1}  <=>  q r = a
            return torch.linalg.solve_triangular(r.to(block.device), block,
                                                 upper=True, left=False)
        return (a.map(solve) if isinstance(a, ShardedRows) else solve(a)), r

    q1, r1 = one_pass(y)
    q2, r2 = one_pass(q1)
    return q2, r2 @ r1


def _qr_method(qr_method: Optional[str]) -> str:
    method = "householder" if qr_method is None else qr_method
    if method not in QR_METHODS:
        raise ValueError(f"qr_method must be one of {QR_METHODS} or None, "
                         f"got {qr_method!r}")
    return method


def _panel_qr(a: Panel, method: str) -> Tuple[Panel, torch.Tensor]:
    if method == "cholesky2":
        return cholesky_qr2(a)
    if isinstance(a, ShardedRows):
        raise ValueError("a row-sharded panel needs qr_method='cholesky2' "
                         "(Householder QR would gather it onto one device)")
    return torch.linalg.qr(a)


def _gathered(panel: Panel) -> torch.Tensor:
    """A sharded panel gathered on its home device without its padding
    rows; a plain tensor as it is."""
    return panel.gather() if isinstance(panel, ShardedRows) else panel


def _power_step(op: MatmulOperator, q: Panel, method: str
                ) -> Tuple[Panel, torch.Tensor]:
    """One two-sided orthogonalized power iteration; returns the refreshed
    range basis and the current singular-value estimates."""
    z, r = _panel_qr(op.rmm(q), method)
    s_est = torch.abs(torch.diagonal(r))
    q, _ = _panel_qr(op.mm(z), method)
    return q, s_est


def _power_until(op: MatmulOperator, q: Panel, k: int, tol: float,
                 max_iter: int, method: str) -> Tuple[Panel, bool, int]:
    """Power iterations until the top-k singular estimates are relatively
    stable below ``tol`` (at most ``max_iter``).  Each convergence test is
    one host sync.  Returns ``(q, converged, iterations)``."""
    s_prev = torch.full((k,), torch.inf, dtype=q.dtype, device=q.device)
    for it in range(1, max_iter + 1):
        q, s_est = _power_step(op, q, method)
        s_top = s_est[:k]
        denom = torch.clamp(torch.abs(s_top), min=1e-30)
        rel = torch.max(torch.abs(s_top - s_prev) / denom)
        s_prev = s_top
        if bool(rel < tol):
            return q, True, it
    return q, False, max_iter


def _finalize(op: MatmulOperator, q: Panel) -> SvdResult:
    b = op.rmm(q).T                     # (b, n) = Q^T A
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    return SvdResult(_gathered(q @ ub), s, vt.T)


def _build_fixed(op: MatmulOperator, pow_op: MatmulOperator,
                 gen: torch.Generator, block: int, n_iter: int,
                 refine_iters: int, dtype: torch.dtype, method: str
                 ) -> SvdResult:
    """The fixed-iteration build: random start, power loop on the power
    operator, full-precision refinement, Rayleigh–Ritz
    (``polara_tpu/ops/rsvd.py:_build_fixed``)."""
    n = op.shape[1]
    omega = torch.randn((n, block), generator=gen, dtype=dtype,
                        device=gen.device)
    q, _ = _panel_qr(pow_op.mm(omega), method)
    for _ in range(n_iter):
        q, _ = _power_step(pow_op, q, method)
    for _ in range(refine_iters):
        q, _ = _power_step(op, q, method)
    return _finalize(op, q)


def randomized_svd(a: Union[torch.Tensor, MatmulOperator], k: int,
                   oversample: Optional[int] = None,
                   n_iter: int = 8, tol: Optional[float] = None,
                   max_iter: int = 100,
                   seed: Optional[int] = 0,
                   dtype: Optional[torch.dtype] = None,
                   qr_method: Optional[str] = None,
                   max_escalations: int = 2,
                   power_operator: Optional[MatmulOperator] = None,
                   refine_iters: int = 2,
                   info: Optional[dict] = None) -> SvdResult:
    """Rank-k truncated SVD (semantics of the JAX package's
    ``randomized_svd``).

    ``power_operator``: optional cheaper operator (e.g. the bf16
    :func:`~polara_tpu_torch.ops.sparse.dense_power_operator`) for the
    power iterations; ``refine_iters`` full-precision steps follow, and
    the Rayleigh–Ritz projection always reads the full-precision matrix.

    With ``tol`` set, power iterations continue (up to ``max_iter``) until
    the top-k singular-value estimates are relatively stable below
    ``tol``; when they are not, the block doubles (fresh random columns)
    up to ``max_escalations`` times.  Without ``tol``, exactly ``n_iter``
    iterations run.

    ``qr_method``: None or ``"householder"`` (``torch.linalg.qr``), or
    ``"cholesky2"`` (:func:`cholesky_qr2`, the only one a row-sharded
    operator takes).

    ``info``, when given, receives the power iterations run per block
    width (``iterations``: ``[(block, count), ...]``) and ``converged``.
    """
    op = _as_operator(a)
    m, n = op.shape
    dtype = dtype or op.dtype
    if k <= 0 or k > min(m, n):
        raise ValueError(f"rank {k} out of range for shape {op.shape}")
    block = min(k + (oversample if oversample is not None else max(10, k)),
                min(m, n))
    method = _qr_method(qr_method)

    pow_op = power_operator if power_operator is not None else op
    if tuple(pow_op.shape) != tuple(op.shape):
        raise ValueError(f"power operator shape {pow_op.shape} does not "
                         f"match {op.shape}")

    gen = generator_from_seed(seed, _operator_device(op))
    if tol is None:
        refine = refine_iters if power_operator is not None else 0
        u, s, v = _build_fixed(op, pow_op, gen, block, n_iter, refine,
                               dtype, method)
        if info is not None:
            info.update(iterations=[(block, n_iter + refine)],
                        converged=None)
        return SvdResult(u=u[:, :k], s=s[:k], v=v[:, :k])

    omega = torch.randn((n, block), generator=gen, dtype=dtype,
                        device=gen.device)
    q, _ = _panel_qr(pow_op.mm(omega), method)
    q, converged, count = _power_until(pow_op, q, k, float(tol), max_iter,
                                       method)
    iterations = [(q.shape[1], count)]
    for _ in range(max_escalations):
        if converged or q.shape[1] >= min(m, n):
            break
        grow = min(q.shape[1], min(m, n) - q.shape[1])
        extra = pow_op.mm(torch.randn((n, grow), generator=gen, dtype=dtype,
                                      device=gen.device))
        if isinstance(q, ShardedRows):
            q = ShardedRows(tuple(torch.cat([a, b], dim=1) for a, b
                                  in zip(q.blocks, extra.blocks)), q.n_rows)
        else:
            q = torch.cat([q, extra], dim=1)
        q, _ = _panel_qr(q, method)
        q, converged, count = _power_until(pow_op, q, k, float(tol),
                                           max_iter, method)
        iterations.append((q.shape[1], count))

    if power_operator is not None and refine_iters > 0:
        for _ in range(refine_iters):
            q, _ = _power_step(op, q, method)
    if info is not None:
        info.update(iterations=iterations, converged=converged)

    u, s, v = _finalize(op, q)
    return SvdResult(u=u[:, :k], s=s[:k], v=v[:, :k])


def _krylov_basis(op: MatmulOperator, omega: torch.Tensor, depth: int,
                  method: str) -> torch.Tensor:
    """Orthonormal block-Krylov basis ``[Z_1 .. Z_depth]`` on the V side.

    Each block is orthogonalized against the accumulated basis (two-pass
    block Gram–Schmidt: one projection leaves O(cond·eps) cross-talk that
    grows with depth) before appending; a final whole-basis QR restores
    orthonormality, since converged Krylov blocks are nearly dependent
    (under CholeskyQR2 with a 1e-5 jitter, which that Gram needs)."""
    q, _ = _panel_qr(op.mm(omega), method)        # (m, b)
    basis = None
    for i in range(depth):
        z, _ = _panel_qr(op.rmm(q), method)       # (n, b)
        if basis is not None:
            z = z - basis @ (basis.T @ z)
            z = z - basis @ (basis.T @ z)
            z, _ = _panel_qr(z, method)
            basis = torch.cat([basis, z], dim=1)
        else:
            basis = z
        if i < depth - 1:
            q, _ = _panel_qr(op.mm(z), method)
    if method == "cholesky2":
        basis, _ = cholesky_qr2(basis, eps=1e-5)
    else:
        basis, _ = torch.linalg.qr(basis)
    return basis


def _finalize_wide(op: MatmulOperator, z: torch.Tensor, method: str
                   ) -> SvdResult:
    """Rayleigh–Ritz over a wide V-side basis without a large SVD: QR the
    (m, w) image, then SVD only the (w, w) factor."""
    qb, rb = _panel_qr(op.mm(z), method)          # (m, w) full precision
    ub, s, wt = torch.linalg.svd(rb, full_matrices=False)
    return SvdResult(_gathered(qb @ ub), s, z @ wt.T)


def _refine_basis(op: MatmulOperator, z: torch.Tensor, n_iter: int,
                  method: str) -> torch.Tensor:
    """Full-precision two-sided power steps over a (n, w) basis — the
    precision-ladder rung that scrubs bf16 Krylov-basis noise."""
    for _ in range(n_iter):
        q, _ = _panel_qr(op.mm(z), method)
        z, _ = _panel_qr(op.rmm(q), method)
    return z


def randomized_svd_krylov(a: Union[torch.Tensor, MatmulOperator], k: int,
                          depth: int = 4,
                          oversample: Optional[int] = None,
                          seed: Optional[int] = 0,
                          dtype: Optional[torch.dtype] = None,
                          qr_method: Optional[str] = None,
                          power_operator: Optional[MatmulOperator] = None,
                          refine_iters: int = 1) -> SvdResult:
    """Rank-k truncated SVD via block Krylov iteration (Musco & Musco;
    semantics of the JAX package's ``randomized_svd_krylov``).

    All ``depth`` blocks are kept and Rayleigh–Ritz-projected together,
    reaching the subspace path's accuracy in about half the passes over
    ``a``; the basis is ``depth * block`` columns wide.  With a
    ``power_operator`` (bf16) the basis builds on it, then one
    Rayleigh–Ritz over the wide basis picks the top ``block`` Ritz
    directions, ``refine_iters`` full-precision power steps refine only
    those (refining the wide basis would collapse its Krylov spread), and
    the final projection reads the full-precision matrix.  ``qr_method``
    as in :func:`randomized_svd`."""
    op = _as_operator(a)
    m, n = op.shape
    dtype = dtype or op.dtype
    if k <= 0 or k > min(m, n):
        raise ValueError(f"rank {k} out of range for shape {op.shape}")
    block = min(k + (oversample if oversample is not None else max(10, k)),
                min(m, n))
    depth = max(1, min(depth, max(1, min(m, n) // block)))
    method = _qr_method(qr_method)
    pow_op = power_operator if power_operator is not None else op
    if tuple(pow_op.shape) != tuple(op.shape):
        raise ValueError(f"power operator shape {pow_op.shape} does not "
                         f"match {op.shape}")

    gen = generator_from_seed(seed, _operator_device(op))
    omega = torch.randn((n, block), generator=gen, dtype=dtype,
                        device=gen.device)
    z = _krylov_basis(pow_op, omega, depth, method)
    if power_operator is not None and refine_iters > 0:
        v = _finalize_wide(op, z, method).v
        z = _refine_basis(op, v[:, :block], refine_iters, method)
    u, s, v = _finalize_wide(op, z, method)
    return SvdResult(u=u[:, :k], s=s[:k], v=v[:, :k])


def principal_angles_max_sin(u1: torch.Tensor, u2: torch.Tensor) -> float:
    """max sin(principal angle) between two column spans — the
    subspace-agreement measure of the parity tests."""
    q1, _ = torch.linalg.qr(u1)
    q2, _ = torch.linalg.qr(u2)
    sv = torch.linalg.svdvals(q1.T @ q2)
    cos = torch.clamp(sv, 0.0, 1.0)
    return float(torch.sqrt(torch.max(1.0 - cos ** 2)))


def orthogonalize(u: torch.Tensor, v: torch.Tensor, complete: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QR-orthogonalize a factor pair (reference ``models.py:567-578``)."""
    qu, ru = torch.linalg.qr(u)
    qv, rv = torch.linalg.qr(v)
    if complete:
        ur, _, vr = torch.linalg.svd(ru @ rv.T)
        return qu @ ur, qv @ vr.T
    return qu, qv
