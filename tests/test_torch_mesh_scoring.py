"""The scoring routes' mesh steps against the JAX package's.

``run_scoring_fused(mesh=...)`` of the port (the kernel's plain version
per shard on the CPU) against ``polara_tpu``'s ``_fused_mesh_step`` and
``_fused_mesh_step_2d`` routes (Pallas in interpret mode on the 8 virtual
devices of ``tests/conftest.py``), on the same numpy inputs: 241 users,
120 or 119 items, dyadic factors (exact scores, so ties are real and the
ids must match bit for bit), the popularity item order.  The JAX 2-D
route pads each item shard to 128 columns, the port to a multiple of 32:
the ids agree whatever the width (the lowest global position wins).
The unfused ``run_scoring(mesh=)`` is held against the JAX package's
sharding-constrained step the same way."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polara_tpu.models.svd import SVDModel as JaxSVD
from polara_tpu.ops.scoring import ChunkedTestData as JaxPlan
from polara_tpu.ops.scoring import run_scoring as jscoring_run
from polara_tpu.ops.scoring import run_scoring_fused as jax_scoring_fused
from polara_tpu.runtime.mesh import make_mesh as jax_make_mesh
from polara_tpu_torch.models.svd import SVDModel as TorchSVD
from polara_tpu_torch.ops import scoring as tscoring
from polara_tpu_torch.ops.fused_topk import seen_mask
from polara_tpu_torch.ops.scoring import ChunkedTestData, run_scoring_fused
from polara_tpu_torch.runtime.mesh import make_mesh

N_USERS, RANK, TOPK = 241, 6, 10


def _inputs(n_items, seed=0):
    """Sorted unique (user, item) events with integer ratings, and dyadic
    item factors."""
    rs = np.random.RandomState(seed)
    rows, cols = [], []
    for u in range(N_USERS):
        items = rs.choice(n_items, size=rs.randint(3, 30), replace=False)
        rows.append(np.full(len(items), u))
        cols.append(np.sort(items))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    vals = rs.randint(1, 6, len(rows)).astype(np.float64)
    v = np.clip(np.round(rs.randn(n_items, RANK) * 4) / 4, -2, 2)
    return rows, cols, vals, v


def _jax_recs(inputs, n_items, shape, filter_seen, chunk_users):
    rows, cols, vals, v = inputs
    plan = JaxPlan.build(rows, cols, vals, N_USERS, n_items,
                         chunk_users=chunk_users, n_shards=shape[0])
    params = {"item_factors": jnp.asarray(v, jnp.float32),
              "item_panel": jnp.asarray(v, jnp.float32)}
    return np.asarray(jax_scoring_fused(
        plan, JaxSVD.proj_chunk, params, TOPK, filter_seen=filter_seen,
        n_valid_cols=n_items, interpret=True,
        mesh=jax_make_mesh(axes=("users", "model"), shape=shape),
        item_order="popularity"))


def _port_recs(inputs, n_items, filter_seen, chunk_users, mesh=None,
               n_shards=1, return_values=False):
    rows, cols, vals, v = inputs
    plan = ChunkedTestData.build(rows, cols, vals, N_USERS, n_items,
                                 chunk_users=chunk_users, device="cpu",
                                 n_shards=n_shards)
    panel = torch.as_tensor(v, dtype=torch.float32)
    params = {"item_factors": panel, "item_panel": panel}
    return run_scoring_fused(plan, TorchSVD.proj_chunk, params, TOPK,
                             filter_seen=filter_seen, n_valid_cols=n_items,
                             mesh=mesh, item_order="popularity",
                             return_values=return_values)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("n_items", [120, 119])
@pytest.mark.parametrize("filter_seen", [True, False])
def test_mesh_fused_ids_equal_jax(shape, n_items, filter_seen):
    inputs = _inputs(n_items)
    chunk_users = None if filter_seen else 60     # 60: padded shard rows
    want = _jax_recs(inputs, n_items, shape, filter_seen, chunk_users)
    mesh = make_mesh(devices=["cpu"] * 8, shape=shape)
    got = _port_recs(inputs, n_items, filter_seen, chunk_users, mesh=mesh,
                     n_shards=shape[0])
    np.testing.assert_array_equal(got, want)
    # the steps' plain version: the whole route on one device
    np.testing.assert_array_equal(
        _port_recs(inputs, n_items, filter_seen, chunk_users), want)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("filter_seen", [True, False])
def test_mesh_fused_values_equal_single_device(shape, filter_seen):
    """With ``return_values`` the mesh steps give the single-device
    route's scores as well as its ids (exact scores: dyadic factors)."""
    inputs = _inputs(119, seed=2)
    mesh = make_mesh(devices=["cpu"] * 8, shape=shape)
    vals, ids = _port_recs(inputs, 119, filter_seen, 60, mesh=mesh,
                           n_shards=shape[0], return_values=True)
    want_vals, want_ids = _port_recs(inputs, 119, filter_seen, 60,
                                     return_values=True)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(vals, want_vals)
    assert vals.dtype == np.float32 and np.isfinite(vals).all()


@pytest.mark.parametrize("shape,chunk_users", [((8, 1), 60), ((4, 2), 60),
                                               ((2, 2), None)])
def test_mesh_fused_runs_the_kernel_once_per_shard_and_chunk(
        monkeypatch, shape, chunk_users):
    """The wrapper is called user shards x item shards x chunks times (on
    the card each call is one launch; tests/test_torch_cuda.py counts
    those)."""
    calls = []
    real = tscoring.fused_score_topk

    def counted(*args, **kwargs):
        calls.append(kwargs.get("n_valid_cols"))
        return real(*args, **kwargs)
    monkeypatch.setattr(tscoring, "fused_score_topk", counted)
    inputs = _inputs(119, seed=1)
    mesh = make_mesh(devices=["cpu"] * int(np.prod(shape)), shape=shape)
    got = _port_recs(inputs, 119, True, chunk_users, mesh=mesh,
                     n_shards=shape[0])
    n_chunks = 1 if chunk_users is None else -(-N_USERS // chunk_users)
    assert len(calls) == shape[0] * shape[1] * n_chunks
    # 2-D: each item shard a whole number of 32-column words
    assert set(calls) == ({119} if shape[1] == 1 else {64})
    monkeypatch.undo()
    np.testing.assert_array_equal(got, _port_recs(inputs, 119, True,
                                                  chunk_users))


@pytest.mark.parametrize("n_valid,n_pad", [(119, 128), (120, 128), (0, 64),
                                           (5, 5), (33, 96), (64, 64),
                                           (1, 1000)])
def test_invalid_col_bits_sets_exactly_the_padded_columns(n_valid, n_pad):
    bits = tscoring._invalid_col_bits(n_valid, n_pad)
    assert bits.dtype == torch.int32
    assert tuple(bits.shape) == (max(1, -(-n_pad // 32)),)
    mask = seen_mask(bits[None, :], bits.shape[0] * 32)[0]
    want = torch.zeros(bits.shape[0] * 32, dtype=torch.bool)
    want[n_valid:n_pad] = True
    assert torch.equal(mask, want)


# --------------------------------------------------------------------------
# the unfused route: score -> shift-formula mask -> top-k per users shard
# --------------------------------------------------------------------------

def _unfused_plans(inputs, n_items, chunk_users, n_shards):
    rows, cols, vals, _ = inputs
    return (JaxPlan.build(rows, cols, vals, N_USERS, n_items,
                          chunk_users=chunk_users, n_shards=n_shards),
            ChunkedTestData.build(rows, cols, vals, N_USERS, n_items,
                                  chunk_users=chunk_users, device="cpu",
                                  n_shards=n_shards))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("n_items", [120, 119])
@pytest.mark.parametrize("chunk_users", [None, 60])
def test_mesh_unfused_ids_equal_jax(shape, n_items, chunk_users):
    """``run_scoring(mesh=)`` against the JAX package's sharding-
    constrained step on its virtual devices: ids identical (exact scores,
    so the shift formula's block-wide minimum and seen maximum must be
    reduced over the shards exactly)."""
    inputs = _inputs(n_items, seed=3)
    jplan, tplan = _unfused_plans(inputs, n_items, chunk_users, shape[0])
    v = inputs[3]
    want = np.asarray(jscoring_run(
        jplan, JaxSVD.score_chunk,
        {"item_factors": jnp.asarray(v, jnp.float32),
         "item_panel": jnp.asarray(v, jnp.float32)}, TOPK,
        n_valid_cols=n_items,
        mesh=jax_make_mesh(axes=("users", "model"), shape=shape)))
    panel = torch.as_tensor(v, dtype=torch.float32)
    got = tscoring.run_scoring(
        tplan, TorchSVD.score_chunk,
        {"item_factors": panel, "item_panel": panel}, TOPK,
        n_valid_cols=n_items,
        mesh=make_mesh(devices=["cpu"] * 8, shape=shape))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards,chunk_users", [(8, 60), (4, None)])
def test_mesh_unfused_scores_each_shard_as_a_chunk_of_its_own(n_shards,
                                                              chunk_users):
    """The scorer is called once per users shard and chunk, on the shard's
    rows only (shard-relative event rows), and the ids equal the
    single-device route's."""
    inputs = _inputs(119, seed=4)
    _, plan = _unfused_plans(inputs, 119, chunk_users, n_shards)
    panel = torch.as_tensor(inputs[3], dtype=torch.float32)
    params = {"item_factors": panel, "item_panel": panel}
    seen = []

    def recorded(p, chunk):
        rows = chunk.rows[chunk.valid]
        seen.append((chunk.users.shape[0], int(chunk.start)))
        assert not len(rows) or int(rows.max()) < chunk.users.shape[0]
        return TorchSVD.score_chunk(p, chunk)
    mesh = make_mesh(devices=["cpu"] * n_shards, shape=(n_shards, 1))
    got = tscoring.run_scoring(plan, recorded, params, TOPK,
                               n_valid_cols=119, mesh=mesh)
    # ceil(chunk_users / shards) rows each, the last shard the rest
    per = -(-plan.chunk_users // n_shards)
    assert seen == [(min(per, plan.chunk_users - i * per),
                     c * plan.chunk_users + i * per)
                    for c in range(len(plan.chunks)) for i in range(n_shards)
                    if i * per < plan.chunk_users]
    np.testing.assert_array_equal(got, tscoring.run_scoring(
        plan, TorchSVD.score_chunk, params, TOPK, n_valid_cols=119))


def test_random_model_scores_whole_chunks_under_a_mesh():
    """A scorer that draws one random stream per chunk is not split over
    the users axis: the random baseline's recommendations under a mesh are
    its recommendations without one."""
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_synthetic_interactions
    from polara_tpu_torch.models import RandomModel
    from polara_tpu_torch.runtime.mesh import use_mesh

    frame = make_synthetic_interactions(n_users=60, n_items=30,
                                        n_events=900, seed=0)
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.prepare()
    model = RandomModel(data, device="cpu", seed=5)
    model.verbose = False
    assert not model.row_local_scores
    single = model.recommendations.copy()
    with use_mesh(make_mesh(devices=["cpu"] * 8)):
        model._recommendations = None
        np.testing.assert_array_equal(model.recommendations, single)
