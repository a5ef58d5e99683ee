"""The SVD family over a device mesh, end to end through the models.

``SVDModel(data, mesh=...)`` of the port (a mesh of repeated ``cpu``
entries) against the single-device port and against ``polara_tpu``'s mesh
model (the 8 virtual CPU devices of ``tests/conftest.py``), on the data of
``tests/test_mesh_models.py`` (240 x 120 and the non-divisible 241 x 119;
rank 6, f64)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from polara_tpu import config as jconfig
from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets.synthetic import make_realistic_interactions
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu.runtime.mesh import make_mesh as jax_make_mesh
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.evaluation.engine import run_cv_experiment
from polara_tpu_torch.models import ScaledSVD, SVDModel
from polara_tpu_torch.ops.rsvd import principal_angles_max_sin
from polara_tpu_torch.runtime.convert import factors_from_jax
from polara_tpu_torch.runtime.mesh import (ShardedRows, make_mesh,
                                           use_mesh)

MESH = make_mesh(devices=["cpu"] * 8, shape=(8, 1))
GEOMETRIES = {
    # tests/test_mesh_models.py:30-38 and :276-282
    "divisible": dict(n_users=240, n_items=120, seed=0, config={}),
    "non_divisible": dict(n_users=241, n_items=119, seed=13,
                          config=dict(warm_start=False, holdout_size=2)),
}


def _data(cls, n_users, n_items, seed, config):
    frame = make_realistic_interactions(n_users=n_users, n_items=n_items,
                                        n_events=7000, seed=seed)
    data = cls(frame, "userid", "movieid", "rating", seed=11)
    data.verbose = False
    for name, value in config.items():
        setattr(data, name, value)
    data.prepare()
    return data


def _model(cls, data, mesh=None, rank=6, **attrs):
    if cls is JaxSVD:
        model = cls(data, mesh=mesh)
        model.compute_dtype = jnp.float64
    else:
        model = cls(data, device="cpu", mesh=mesh)
        model.compute_dtype = torch.float64
    model.verbose = False
    model.rank = rank
    for name, value in attrs.items():
        setattr(model, name, value)
    return model


def _hr(model) -> float:
    return float(model.evaluate("relevance", simple_rates=True).hr)


def _item_factors(model) -> torch.Tensor:
    v = model.factors[model.data.fields.itemid]
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.array(v))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_svd_model_mesh_matches_single_device_and_jax(geometry):
    """The mesh build (row-sharded dense block, CholeskyQR2) spans the
    single-device subspace to a sine of 1e-6 and gives the same hit rate
    within 1e-6; so does the JAX package's mesh model.  Twenty fixed
    power iterations (one compiled JAX program) reach a sine of ~4e-8
    from the converged subspace on this data."""
    fixed = dict(svd_tol=None, svd_iters=20)
    tdata = _data(TorchData, **GEOMETRIES[geometry])
    single = _model(SVDModel, tdata, **fixed)
    single.build(return_factors="uvh")
    dist = _model(SVDModel, tdata, mesh=MESH, **fixed)
    dist.build(return_factors="uvh")
    block = tdata._device_matrix_cache[("svd_dense", MESH, ())]
    assert isinstance(block, ShardedRows) and len(block.blocks) == 8
    # padding rows are dropped from the user factors
    assert block.n_rows == single.factors["userid"].shape[0]
    assert tuple(dist.factors["userid"].shape) == tuple(
        single.factors["userid"].shape)
    assert principal_angles_max_sin(_item_factors(single),
                                    _item_factors(dist)) < 1e-6
    np.testing.assert_allclose(dist.factors["singular_values"].numpy(),
                               single.factors["singular_values"].numpy(),
                               rtol=1e-10)
    recs_single, recs_dist = single.recommendations, dist.recommendations
    assert recs_dist.shape == recs_single.shape
    assert (recs_single == recs_dist).mean() > 0.999
    assert abs(_hr(single) - _hr(dist)) < 1e-6

    jdata = _data(JaxData, **GEOMETRIES[geometry])
    ref = _model(JaxSVD, jdata,
                 mesh=jax_make_mesh(axes=("users", "model"), shape=(8, 1)),
                 **fixed)
    ref.build()
    assert principal_angles_max_sin(_item_factors(ref),
                                    _item_factors(dist)) < 1e-6
    assert abs(_hr(ref) - _hr(dist)) < 1e-6


def test_mesh_build_routes_krylov_scaled_and_power_copy():
    """Krylov, ScaledSVD and the bf16 power copy take the mesh branch:
    each caches a row-sharded block and spans its single-device
    counterpart's subspace.  Fixed iteration counts: from one random
    start both QR methods span the same subspace at every step."""
    tdata = _data(TorchData, **GEOMETRIES["non_divisible"])
    fixed = dict(svd_tol=None, svd_iters=6)
    # the bf16 passes round two different bases (bf16's unit roundoff is
    # 3.9e-3); two f32 refinement steps leave ~1e-4 of that
    cases = [(SVDModel, dict(svd_method="krylov"), 1e-6),
             (ScaledSVD, fixed, 1e-6),
             (SVDModel, dict(svd_power_dtype=torch.bfloat16, **fixed),
              1e-3)]
    for cls, attrs, bound in cases:
        single = _model(cls, tdata, **attrs)
        single.build()
        dist = _model(cls, tdata, mesh=MESH, **attrs)
        dist.build()
        key = dist._last_dense_key
        assert key[1] == MESH
        assert isinstance(tdata._device_matrix_cache[key], ShardedRows)
        if "svd_power_dtype" in attrs:
            power = tdata._device_matrix_cache[key + ("power",
                                                      torch.bfloat16)]
            (lo,) = power.operands
            assert isinstance(lo, ShardedRows)
            assert lo.dtype == torch.bfloat16
        sin = principal_angles_max_sin(_item_factors(single),
                                       _item_factors(dist))
        assert sin < bound, (cls.__name__, attrs, sin)


@pytest.fixture(scope="module")
def jax_factors():
    """f32 factors of the JAX model on the 240 x 120 data (a fixed
    iteration count: only the scoring routes are compared)."""
    jdata = _data(JaxData, **GEOMETRIES["divisible"])
    ref = _model(JaxSVD, jdata, svd_tol=None, svd_iters=4)
    ref.compute_dtype = jnp.float32
    ref.build()
    return {k: None if v is None else np.array(v)
            for k, v in ref.factors.items()}


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("filter_seen", [True, False])
def test_fused_mesh_model_ids_equal_jax(jax_factors, shape, filter_seen):
    """JAX factors carried over: the port's fused route under a mesh (the
    kernel's plain version once per shard) gives the JAX package's Pallas
    mesh route's ids exactly (tests/test_mesh_models.py:320-406)."""
    geometry = GEOMETRIES["divisible"]
    jdata = _data(JaxData, **geometry)
    ref = _model(JaxSVD, jdata, mesh=jax_make_mesh(axes=("users", "model"),
                                                   shape=shape),
                 filter_seen=filter_seen)
    ref.factors = {k: None if v is None else jnp.asarray(v)
                   for k, v in jax_factors.items()}
    ref._is_ready = True
    saved = jconfig.get_default("pallas_scoring")
    jconfig.set_default("pallas_scoring", True)
    try:
        want = ref.recommendations
    finally:
        jconfig.set_default("pallas_scoring", saved)

    tdata = _data(TorchData, **geometry)
    port = _model(SVDModel, tdata,
                  mesh=make_mesh(devices=["cpu"] * 8, shape=shape),
                  filter_seen=filter_seen)
    port.set_factors(factors_from_jax(jax_factors, device="cpu"))
    saved = tconfig.get_default("fused_scoring")
    tconfig.set_default("fused_scoring", True)
    try:
        assert port.uses_fused_scoring(port.score_params())
        np.testing.assert_array_equal(port.recommendations, want)
    finally:
        tconfig.set_default("fused_scoring", saved)


def test_mesh_change_replans_the_test_chunks():
    """The plan cache key holds the users-axis size and the distinct
    devices of its shards: a model scored without a mesh and then under
    one re-plans with chunks aligned to the mesh."""
    tdata = _data(TorchData, **GEOMETRIES["non_divisible"])
    model = _model(SVDModel, tdata, svd_tol=None, svd_iters=8)
    single = model.recommendations.copy()
    assert model._test_plan_layout == (1, 1)
    with use_mesh(MESH):
        model._recommendations = None
        meshed = model.recommendations
        assert model._test_plan_layout == (8, 1)
        assert model._test_plan.chunk_users % 8 == 0
    assert {key[-2:] for key in tdata._test_plan_cache} == {(1, 1), (8, 1)}
    np.testing.assert_array_equal(meshed, single)


def test_mesh_beyond_budget_raises_instead_of_another_route():
    """Past the memory budget even for the COO products, the mesh build
    takes the event-sharded streaming rSVD (``distributed_chunked_rsvd``,
    which it raised for until that was ported), never a dense or COO
    route: f64, 8 iterations from the same start as the single-device
    streaming build, so the singular values agree to 1e-10 relative, the
    item spans to a sine of 1e-6, and the recommendations id for id."""
    tdata = _data(TorchData, **GEOMETRIES["divisible"])
    saved = tconfig.get_default("hbm_score_budget_gb")
    tconfig.set_default("hbm_score_budget_gb", 1e-7)
    try:
        meshed = _model(SVDModel, tdata, mesh=MESH, svd_tol=None,
                        svd_iters=8)
        single = _model(SVDModel, tdata, svd_tol=None, svd_iters=8)
        meshed.build()
        single.build()
    finally:
        tconfig.set_default("hbm_score_budget_gb", saved)
    # scored under the default budget (1e-7 GiB holds no score row)
    want, got = single.recommendations, meshed.recommendations
    np.testing.assert_allclose(meshed.factors["singular_values"].numpy(),
                               single.factors["singular_values"].numpy(),
                               rtol=1e-10)
    assert principal_angles_max_sin(_item_factors(meshed),
                                    _item_factors(single)) < 1e-6
    np.testing.assert_array_equal(got, want)
    assert not any(isinstance(key, tuple) and key[:1] == ("svd_dense",)
                   for key in tdata._device_matrix_cache)


def test_cv_experiment_under_mesh_matches_single_device():
    """The CV engine is mesh-transparent (tests/test_mesh_models.py:220):
    fold rotation and rebuilds under ``use_mesh`` give the single-device
    per-fold metrics."""
    def run(active_mesh):
        data = _data(TorchData, n_users=240, n_items=120, seed=9, config={})
        model = _model(SVDModel, data, rank=5, svd_tol=None, svd_iters=8)
        with use_mesh(active_mesh):
            return run_cv_experiment([model], folds=[1, 2],
                                     metrics="ranking")

    single = run(None)
    dist = run(MESH)
    assert (single.index == dist.index).all()
    np.testing.assert_allclose(single.values.astype(float),
                               dist.values.astype(float), atol=1e-9)


def test_mesh_of_repeated_entries_budgets_for_one_device(monkeypatch):
    """Eight ``cpu`` entries hold the sharded block on one device: a dense
    block over that device's budget takes no dense mesh route, although
    it fits eight times the budget; past the COO products' budget too,
    the build streams the events over the mesh
    (``distributed_chunked_rsvd``, once)."""
    import polara_tpu_torch.models.svd as tsvd_module
    calls = []
    streamed = tsvd_module.distributed_chunked_rsvd
    monkeypatch.setattr(tsvd_module, "distributed_chunked_rsvd",
                        lambda *a, **k: calls.append(1) or streamed(*a, **k))
    tdata = _data(TorchData, **GEOMETRIES["divisible"])
    dense_bytes = 240 * 120 * 8
    saved = tconfig.get_default("hbm_score_budget_gb")
    tconfig.set_default("hbm_score_budget_gb", dense_bytes / 2 / 2 ** 30)
    try:
        _model(SVDModel, tdata, mesh=MESH, svd_tol=None,
               svd_iters=4).build()
        assert calls == [1]
        assert not any(isinstance(key, tuple) and key[:1] == ("svd_dense",)
                       for key in tdata._device_matrix_cache)
    finally:
        tconfig.set_default("hbm_score_budget_gb", saved)
