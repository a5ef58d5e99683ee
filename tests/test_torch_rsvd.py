"""Randomized SVD of the port (``polara_tpu_torch.ops.rsvd``) against the
JAX package's on the same numpy matrix.

The two packages draw their random start panels from different streams
(torch.Generator vs jax.random), so factors are never compared as arrays:
singular values and subspaces are.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polara_tpu.ops.rsvd import randomized_svd as jax_rsvd
from polara_tpu.ops.sparse import dense_power_operator as jax_power_op
from polara_tpu_torch.ops.rsvd import cholesky_qr2, randomized_svd
from polara_tpu_torch.ops.sparse import dense_power_operator

K = 10
# top-10 well separated from a geometric tail: s_11/s_10 = 0.1
SPECTRUM = np.r_[np.linspace(10.0, 5.0, K), 0.5 * 0.9 ** np.arange(40)]


def _matrix(m=300, n=200, seed=0):
    rs = np.random.RandomState(seed)
    u, _ = np.linalg.qr(rs.randn(m, len(SPECTRUM)))
    v, _ = np.linalg.qr(rs.randn(n, len(SPECTRUM)))
    return (u * SPECTRUM) @ v.T


def _max_sin(a, b):
    """sin of the largest principal angle between two column spans, as
    ||(I - Qa Qaᵀ) Qb||₂ (accurate where sqrt(1 - cos²) is not)."""
    qa, _ = np.linalg.qr(np.asarray(a, np.float64))
    qb, _ = np.linalg.qr(np.asarray(b, np.float64))
    return np.linalg.norm(qb - qa @ (qa.T @ qb), 2)


@pytest.mark.parametrize("tol", [None, 1e-12])
def test_f64_matches_jax(tol):
    """Fixed-count and tolerance paths in f64: singular values to 1e-10
    relative, max principal-angle sine < 1e-8 on both sides."""
    a = _matrix()
    ours = randomized_svd(torch.as_tensor(a), K, n_iter=8, tol=tol, seed=0)
    ref = jax_rsvd(jnp.asarray(a), K, n_iter=8, tol=tol, seed=0,
                   dtype=jnp.float64)
    assert ours.s.dtype == torch.float64
    np.testing.assert_allclose(ours.s.numpy(), np.asarray(ref.s), rtol=1e-10)
    np.testing.assert_allclose(ours.s.numpy(), SPECTRUM[:K], rtol=1e-10)
    assert _max_sin(ours.v, ref.v) < 1e-8
    assert _max_sin(ours.u, ref.u) < 1e-8


def test_tolerance_path_escalates_block():
    """A block too narrow to converge within max_iter doubles (the JAX
    package's auto-escalation) and still finds the top subspace."""
    a = _matrix(seed=1)
    ours = randomized_svd(torch.as_tensor(a), K, oversample=0, tol=1e-13,
                          max_iter=3, seed=0)
    ref = jax_rsvd(jnp.asarray(a), K, oversample=0, tol=1e-13, max_iter=3,
                   seed=0, dtype=jnp.float64)
    np.testing.assert_allclose(ours.s.numpy(), np.asarray(ref.s), rtol=1e-8)
    assert _max_sin(ours.v, ref.v) < 1e-6


def test_f32_bf16_power_operator_matches_jax():
    """f32 with the bf16 power operator and the f32 refinement ladder:
    singular values to 2e-3 relative (bf16 keeps ~3 digits; the ladder
    and the f32 Rayleigh–Ritz recover most of the rest)."""
    a = _matrix(seed=2).astype(np.float32)
    ta = torch.as_tensor(a)
    ours = randomized_svd(ta, K, n_iter=6, seed=0,
                          power_operator=dense_power_operator(ta))
    ja = jnp.asarray(a)
    ref = jax_rsvd(ja, K, n_iter=6, seed=0, dtype=jnp.float32,
                   power_operator=jax_power_op(ja))
    assert ours.s.dtype == torch.float32
    np.testing.assert_allclose(ours.s.numpy(), np.asarray(ref.s), rtol=2e-3)
    np.testing.assert_allclose(ours.s.numpy(), SPECTRUM[:K], rtol=2e-3)


def test_cholesky_qr2_orthogonality():
    rs = np.random.RandomState(3)
    y = torch.as_tensor(rs.randn(400, 30))
    q, r = cholesky_qr2(y)
    eye = torch.eye(30, dtype=torch.float64)
    assert torch.linalg.norm(q.T @ q - eye) < 1e-12
    assert torch.allclose(q @ r, y, rtol=0, atol=1e-12)
    assert torch.equal(r, torch.triu(r))


def test_principal_angles_and_orthogonalize_match_jax():
    """``principal_angles_max_sin`` and ``orthogonalize`` (both modes)
    against the JAX package's on the same f64 panels, to 1e-6."""
    from polara_tpu.ops.rsvd import orthogonalize as jax_orth
    from polara_tpu.ops.rsvd import principal_angles_max_sin as jax_angles
    from polara_tpu_torch.ops.rsvd import (orthogonalize,
                                           principal_angles_max_sin)
    rs = np.random.RandomState(4)
    a, b = rs.randn(60, 6), rs.randn(60, 6)
    b_near = a + 1e-3 * rs.randn(60, 6)
    for x, y in ((a, b), (a, b_near)):
        np.testing.assert_allclose(
            principal_angles_max_sin(torch.as_tensor(x), torch.as_tensor(y)),
            jax_angles(jnp.asarray(x), jnp.asarray(y)), rtol=0, atol=1e-6)
    u, v = rs.randn(50, 5), rs.randn(40, 5)
    for complete in (False, True):
        got = orthogonalize(torch.as_tensor(u), torch.as_tensor(v),
                            complete=complete)
        want = jax_orth(jnp.asarray(u), jnp.asarray(v), complete=complete)
        for g, w in zip(got, want):
            # QR/SVD factors are defined up to column signs
            g, w = g.numpy(), np.asarray(w)
            signs = np.sign((g * w).sum(0))
            np.testing.assert_allclose(g * signs, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_krylov_matches_jax(bf16):
    """Block Krylov in f32, with and without the bf16 power operator and
    its f32 refinement: singular values within 1e-4 relative of the JAX
    package's and max principal-angle sine <= 1e-3 between the two V
    subspaces (f32 solves from different random starts)."""
    from polara_tpu.ops.rsvd import randomized_svd_krylov as jax_krylov
    from polara_tpu_torch.ops.rsvd import randomized_svd_krylov
    a = _matrix(seed=5).astype(np.float32)
    ta, ja = torch.as_tensor(a), jnp.asarray(a)
    ours = randomized_svd_krylov(
        ta, K, depth=3, seed=0,
        power_operator=dense_power_operator(ta) if bf16 else None)
    ref = jax_krylov(ja, K, depth=3, seed=0, qr_method="householder",
                     power_operator=jax_power_op(ja) if bf16 else None)
    assert ours.s.dtype == torch.float32
    np.testing.assert_allclose(ours.s.numpy(), np.asarray(ref.s), rtol=1e-4)
    assert _max_sin(ours.v, ref.v) <= 1e-3
    assert _max_sin(ours.u, ref.u) <= 1e-3


def test_tolerance_path_reports_iterations():
    """``info`` records the power iterations per block width and whether
    the tolerance was met."""
    a = _matrix(seed=1)
    info = {}
    randomized_svd(torch.as_tensor(a), K, oversample=0, tol=1e-13,
                   max_iter=3, seed=0, info=info)
    assert info["iterations"][0] == (K, 3)
    assert [b for b, _ in info["iterations"]] == [K, 2 * K, 4 * K]
    assert all(1 <= n <= 3 for _, n in info["iterations"])
