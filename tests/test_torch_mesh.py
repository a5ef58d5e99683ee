"""The port's device mesh (``polara_tpu_torch.runtime.mesh``): shapes and
errors of ``make_mesh`` as in ``polara_tpu.runtime.mesh``, value
semantics, the default mesh, row sharding and the collectives.  Meshes of
repeated ``cpu`` entries stand in for the JAX tests' virtual devices."""
import numpy as np
import pytest
import torch

from polara_tpu.runtime.mesh import make_mesh as jax_make_mesh
from polara_tpu_torch.runtime import mesh as tmesh
from polara_tpu_torch.runtime.mesh import (ShardedRows, all_gather,
                                           device_grid, get_default_mesh,
                                           make_mesh, psum, replicated,
                                           set_default_mesh,
                                           shard_device_count, shard_rows,
                                           use_mesh, user_sharding,
                                           users_devices)

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("kwargs", [
    dict(), dict(shape=(4, 2)), dict(axes=("users",), shape=(8,)),
    dict(n_devices=4, shape=(2, 2)),
    dict(axes=("users", "model", "extra"), shape=(2, 2, 2)),
])
def test_make_mesh_shapes_match_jax(kwargs):
    """Axis names and sizes as the JAX package's ``make_mesh`` gives them
    on its 8 virtual devices."""
    want = jax_make_mesh(**kwargs)
    got = make_mesh(devices=CPU8, **kwargs)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert got.size == want.devices.size
    assert all(d == torch.device("cpu") for d in got.devices.flat)


@pytest.mark.parametrize("kwargs", [dict(shape=(3, 2)),
                                    dict(n_devices=6, shape=(4, 2))])
def test_make_mesh_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(**kwargs)
    with pytest.raises(ValueError) as got:
        make_mesh(devices=CPU8, **kwargs)
    assert str(got.value) == str(want.value)


def test_make_mesh_needs_one_axis_name_per_dimension():
    with pytest.raises(ValueError, match="axis names"):
        make_mesh(devices=CPU8, axes=("users",), shape=(4, 2))


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(shape=(1, 1))


def test_mesh_hash_and_equality():
    a = make_mesh(devices=CPU8, shape=(4, 2))
    b = make_mesh(devices=[torch.device("cpu")] * 8, shape=(4, 2))
    assert a == b and hash(a) == hash(b) and a is not b
    assert {a: 1}[b] == 1
    assert a != make_mesh(devices=CPU8, shape=(8, 1))
    assert a != make_mesh(devices=CPU8, shape=(4, 2), axes=("rows", "cols"))
    assert a != make_mesh(devices=["cpu"] * 7 + ["meta"], shape=(4, 2))
    assert a != "not a mesh"


def test_device_grid_and_users_devices():
    mesh = make_mesh(devices=["cpu", "meta"] * 2, shape=(2, 2))
    grid = device_grid(mesh)
    assert grid.shape == (2, 2)
    assert [str(d) for d in grid[:, 1]] == ["meta", "meta"]
    assert users_devices(mesh) == [torch.device("cpu")] * 2
    one_axis = make_mesh(devices=["cpu", "meta"], axes=("users",))
    assert device_grid(one_axis).shape == (2, 1)
    assert users_devices(one_axis) == [torch.device("cpu"),
                                       torch.device("meta")]


def test_default_mesh_round_trip_routes_models():
    """``set_default_mesh``/``use_mesh`` install and restore the default,
    and a model without ``mesh=`` picks it up (as
    tests/test_mesh_models.py checks for the JAX package)."""
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_synthetic_interactions
    from polara_tpu_torch.models import SVDModel

    mesh = make_mesh(devices=CPU8)
    assert get_default_mesh() is None
    set_default_mesh(mesh)
    try:
        assert get_default_mesh() is mesh
    finally:
        set_default_mesh(None)
    assert get_default_mesh() is None

    frame = make_synthetic_interactions(n_users=60, n_items=30,
                                        n_events=900, seed=0)
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.prepare()
    model = SVDModel(data, device="cpu")
    model.verbose = False
    model.rank = 4
    model.svd_tol = None           # a fixed iteration count: routing only
    assert model.active_mesh is None and model._mesh_layout() == (1, 1)
    with use_mesh(mesh) as active:
        assert active is mesh and model.active_mesh is mesh
        assert model._mesh_layout() == (8, 1)
        model.build()
        block = data._device_matrix_cache[("svd_dense", mesh, ())]
        assert isinstance(block, ShardedRows) and len(block.blocks) == 8
        assert model.recommendations.shape[1] == model.topk
    assert model.active_mesh is None
    pinned = SVDModel(data, device="cpu", mesh=mesh)
    assert pinned.active_mesh is mesh


def test_placements():
    mesh = make_mesh(devices=CPU8, shape=(4, 2))
    assert user_sharding(mesh) == (mesh, ("users", None))
    assert replicated(mesh).spec == ()


@pytest.mark.parametrize("n_rows,shape", [(21, (8, 1)), (24, (8, 1)),
                                          (5, (8, 1)), (21, (4, 2))])
def test_shard_rows_pads_and_keeps_the_true_count(n_rows, shape):
    mesh = make_mesh(devices=CPU8, shape=shape)
    x = torch.arange(n_rows * 3, dtype=torch.float64).view(n_rows, 3) + 1
    sharded = shard_rows(x, mesh)
    n_shards = shape[0]
    per = tmesh.pad_to_multiple(n_rows, n_shards) // n_shards
    assert sharded.n_rows == n_rows
    assert len(sharded.blocks) == n_shards
    assert all(tuple(b.shape) == (per, 3) for b in sharded.blocks)
    assert sharded.shape == (per * n_shards, 3)
    whole = torch.cat(sharded.blocks)
    assert torch.equal(whole[:n_rows], x)
    assert not whole[n_rows:].any()          # zero padding
    assert torch.equal(sharded.gather(), x)
    # full blocks on the tensor's device are views, not copies
    assert sharded.blocks[0].data_ptr() == x.data_ptr()
    doubled = sharded @ (2 * torch.eye(3, dtype=x.dtype))
    assert torch.equal(doubled.gather(), 2 * x)


def test_psum_and_all_gather_keep_shard_order():
    rs = np.random.RandomState(0)
    parts = [torch.as_tensor(rs.randn(4, 3).astype(np.float32) * 10 ** i)
             for i in range(6)]
    want = parts[0]
    for part in parts[1:]:
        want = want + part                  # left fold in shard order
    assert torch.equal(psum(parts), want)
    assert torch.equal(all_gather(parts), torch.cat(parts))
    assert torch.equal(all_gather(parts, dim=1), torch.cat(parts, dim=1))
    assert psum(parts, "cpu").device == torch.device("cpu")


def test_budgets_scale_by_the_distinct_devices_of_the_shards():
    """A per-device budget scales by the distinct devices holding users
    shards, not by the mesh entries: a mesh that repeats one device plans
    for one device, with chunks still aligned to its users axis; with a
    device per shard the planner matches the JAX package's."""
    from polara_tpu.runtime.memory import plan_user_chunks as jax_plan
    from polara_tpu_torch.runtime.memory import plan_user_chunks

    assert shard_device_count(make_mesh(devices=CPU8, shape=(4, 2))) == 1
    assert shard_device_count(make_mesh(devices=["cpu", "meta"],
                                        axes=("users",))) == 2
    assert shard_device_count(make_mesh(devices=["cpu", "meta"] * 2,
                                        shape=(2, 2))) == 1
    gb = 64 * 100 * 4 / 2 ** 30              # 64 rows of 100 f32 scores
    assert plan_user_chunks(1000, 100, budget_gb=gb)[0] == (0, 64)
    assert plan_user_chunks(1000, 100, budget_gb=gb, n_shards=8,
                            n_devices=1)[0] == (0, 64)
    assert plan_user_chunks(1000, 100, budget_gb=gb, n_shards=8,
                            n_devices=1)[1] == (64, 128)
    spread = plan_user_chunks(1000, 100, budget_gb=gb, n_shards=8)
    assert spread[0] == (0, 512)
    assert spread == jax_plan(1000, 100, budget_gb=gb, n_shards=8)
