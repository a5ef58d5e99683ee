"""``polara_tpu_torch.parallel`` against ``polara_tpu.parallel`` on the
same numpy inputs.  The JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``; the port's meshes repeat the ``cpu`` device."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import jax

from polara_tpu import parallel as jpar
from polara_tpu.runtime.mesh import make_mesh as jax_make_mesh
from polara_tpu_torch import parallel as tpar
from polara_tpu_torch.ops.rsvd import principal_angles_max_sin
from polara_tpu_torch.runtime.mesh import ShardedRows, make_mesh, shard_rows

CPU8 = ["cpu"] * 8


def _exact_v(a: np.ndarray, k: int) -> torch.Tensor:
    return torch.as_tensor(np.linalg.svd(a, full_matrices=False)[2][:k].T)


@pytest.mark.parametrize("n_rows,eps", [(203, 0.0), (200, 0.0),
                                        (203, 1e-5)])
def test_sharded_cholesky_qr2_matches_unsharded_and_jax(n_rows, eps):
    """f64: the sharded factorization (Gram psum, local solves) equals the
    unsharded one and the JAX package's to 1e-12."""
    rs = np.random.RandomState(0)
    y = rs.randn(n_rows, 12)
    mesh = make_mesh(devices=CPU8)
    q_s, r_s = tpar.cholesky_qr2(shard_rows(torch.as_tensor(y), mesh),
                                 eps=eps)
    q, r = tpar.cholesky_qr2(torch.as_tensor(y), eps=eps)
    q_j, r_j = jpar.cholesky_qr2(jnp.asarray(y), eps=eps)
    assert isinstance(q_s, ShardedRows)
    np.testing.assert_allclose(q_s.gather().numpy(), q.numpy(), atol=1e-12)
    np.testing.assert_allclose(r_s.numpy(), r.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=1e-12)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=1e-12,
                               atol=1e-12)
    if not eps:
        np.testing.assert_allclose(q.T @ q, np.eye(12), atol=1e-12)
        np.testing.assert_allclose(q @ r, y, atol=1e-12)


def test_cholesky_qr2_raises_on_a_singular_panel():
    """A panel whose Gram is not positive definite raises; nothing falls
    back to Householder QR."""
    y = torch.as_tensor(np.random.RandomState(1).randn(40, 5))
    y[:, 3] = 0.0
    mesh = make_mesh(devices=CPU8)
    for panel in (y, shard_rows(y, mesh)):
        with pytest.raises(torch.linalg.LinAlgError):
            tpar.cholesky_qr2(panel)


@pytest.mark.parametrize("n_rows", [160, 163])
def test_distributed_randomized_svd_matches_jax(n_rows):
    """The JAX test's geometric spectrum on a (8, 1) mesh, f64: singular
    values to 1e-8 relative and subspaces to 1e-6 against the JAX
    package's (160 rows: it needs rows divisible by the mesh) and against
    the exact SVD (different random streams, so both sides are held to
    the exact answer too)."""
    rs = np.random.RandomState(1)
    u, _ = np.linalg.qr(rs.randn(n_rows, 60))
    v, _ = np.linalg.qr(rs.randn(60, 60))
    a = (u * np.power(0.7, np.arange(60))) @ v.T
    exact_s = np.linalg.svd(a, compute_uv=False)[:8]
    mesh = make_mesh(devices=CPU8, shape=(8, 1))
    got = tpar.distributed_randomized_svd(torch.as_tensor(a), 8, mesh,
                                          n_iter=30, seed=0)
    assert tuple(got.u.shape) == (n_rows, 8)
    np.testing.assert_allclose(got.s.numpy(), exact_s, rtol=1e-8)
    assert principal_angles_max_sin(got.v, _exact_v(a, 8)) < 1e-6
    resid = a @ got.v.numpy() - got.u.numpy() * got.s.numpy()
    assert np.abs(resid).max() < 1e-8
    if n_rows % 8 == 0:
        want = jpar.distributed_randomized_svd(jnp.asarray(a), 8,
                                               jax_make_mesh(shape=(8, 1)),
                                               n_iter=30, seed=0)
        np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s),
                                   rtol=1e-8)
        assert principal_angles_max_sin(
            got.v, torch.as_tensor(np.array(want.v))) < 1e-6
        assert principal_angles_max_sin(
            torch.as_tensor(np.array(want.v)), _exact_v(a, 8)) < 1e-6


def _seen(profiles: np.ndarray):
    rows, cols = np.nonzero(profiles)
    return rows, cols


def test_score_mask_topk_step_matches_jax():
    """Dyadic factors and integer profiles (exact scores): identical ids,
    unsharded and over 8 row shards of a non-divisible user count.  Three
    users have fewer unseen items than k, so seen items fill their tails
    through the block-wide shift formula."""
    rs = np.random.RandomState(0)
    n_users, n_items, rank, topk = 61, 40, 6, 8
    v = np.clip(np.round(rs.randn(n_items, rank) * 4) / 4, -2, 2)
    profiles = (rs.rand(n_users, n_items) < 0.2) * rs.randint(
        1, 6, (n_users, n_items))
    profiles[[3, 30, 58], :36] = 2
    profiles = profiles.astype(np.float64)
    rows, cols = _seen(profiles)
    want = np.asarray(jpar.score_mask_topk_step(
        jnp.asarray(v), jnp.asarray(profiles), jnp.asarray(rows, jnp.int32),
        jnp.asarray(cols, jnp.int32), jnp.ones(len(rows), bool), topk))
    args = (torch.as_tensor(rows), torch.as_tensor(cols),
            torch.ones(len(rows), dtype=torch.bool), topk)
    tv, tp = torch.as_tensor(v), torch.as_tensor(profiles)
    plain = tpar.score_mask_topk_step(tv, tp, *args).numpy()
    mesh = make_mesh(devices=CPU8)
    sharded = tpar.score_mask_topk_step(tv, shard_rows(tp, mesh), *args)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(sharded.numpy(), want)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1)])
def test_sharded_score_topk_2d_matches_jax(shape):
    """The JAX test's case (32 users x 64 items, rank 6, k 5) with dyadic
    factors: identical ids on every 2-D mesh shape."""
    rs = np.random.RandomState(0)
    n_users, n_items, rank, topk = 32, 64, 6, 5
    v = np.clip(np.round(rs.randn(n_items, rank) * 4) / 4, -2, 2)
    profiles = ((rs.rand(n_users, n_items) < 0.2)
                * rs.randint(1, 6, (n_users, n_items))).astype(np.float64)
    want = np.asarray(jpar.sharded_score_topk_2d(
        jnp.asarray(v), jnp.asarray(profiles), topk,
        jax_make_mesh(n_devices=8, axes=("users", "model"), shape=shape)))
    mesh = make_mesh(devices=CPU8, shape=shape)
    got = tpar.sharded_score_topk_2d(torch.as_tensor(v),
                                     torch.as_tensor(profiles), topk, mesh)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_score_topk_2d_rejects_a_ragged_item_axis():
    mesh = make_mesh(devices=CPU8, shape=(2, 4))
    with pytest.raises(ValueError, match="must divide"):
        tpar.sharded_score_topk_2d(torch.zeros(63, 4), torch.zeros(8, 63),
                                   5, mesh)


def test_full_train_step_matches_jax():
    """The JAX test's inputs with one numpy random start (f64): the same
    hit count and recommendations as the JAX step on the 8 virtual
    devices, sharded or not."""
    rs = np.random.RandomState(2)
    n_users, n_items, k, topk = 64, 40, 4, 5
    r = rs.rand(n_users, n_items) * (rs.rand(n_users, n_items) < 0.3)
    omega = rs.randn(n_items, k + 4)
    rows, cols = _seen(r)
    holdout = rs.randint(0, n_items, n_users)

    jmesh = jax_make_mesh(axes=("users", "model"))
    users_sh = NamedSharding(jmesh, P("users", None))
    want = jpar.full_train_step(
        jax.device_put(jnp.asarray(r), users_sh), jnp.asarray(omega),
        jax.device_put(jnp.asarray(r), users_sh),
        jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
        jnp.ones(len(rows), bool),
        jax.device_put(jnp.asarray(holdout),
                       NamedSharding(jmesh, P("users"))),
        n_iter=3, k=k, topk=topk)

    mesh = make_mesh(devices=CPU8)
    tr = torch.as_tensor(r)
    seen = (torch.as_tensor(rows), torch.as_tensor(cols),
            torch.ones(len(rows), dtype=torch.bool))
    for r_in, p_in in ((shard_rows(tr, mesh), shard_rows(tr, mesh)),
                       (tr, tr)):
        got = tpar.full_train_step(r_in, torch.as_tensor(omega), p_in,
                                   *seen, torch.as_tensor(holdout),
                                   n_iter=3, k=k, topk=topk)
        assert int(got.hit_count) == int(want.hit_count)
        np.testing.assert_array_equal(got.recommendations.numpy(),
                                      np.asarray(want.recommendations))
        np.testing.assert_allclose(got.factors.s.numpy(),
                                   np.asarray(want.factors.s), rtol=1e-10)
