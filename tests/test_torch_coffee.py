"""The port's ``CoffeeModel`` on the data model, against ``polara_tpu``'s
on the CPU, and ``find_optimal_tucker_ranks``.

Both packages read the same events (``make_synthetic_interactions``,
80 users x 40 items, ratings 1..5).  Carried factors are dyadic
(multiples of 1/4), so every level weight, projection and score is exact
in f32 and the ids must match bit for bit, ties included.  Builds run in
f64 from the JAX package's own seeded start.  Each tolerance is stated
with its test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu.evaluation.pipelines import \
    find_optimal_tucker_ranks as jax_tucker_ranks
from polara_tpu.models import CoffeeModel as JaxCoffee
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.evaluation import find_optimal_tucker_ranks
from polara_tpu_torch.models import CoffeeModel, SVDModel
from polara_tpu_torch.runtime.convert import factors_from_jax
from polara_tpu_torch.runtime.mesh import make_mesh

MLRANK = (6, 5, 2)


def _data(cls, warm_start):
    events = make_synthetic_interactions(n_users=80, n_items=40,
                                         n_events=1600, seed=0)
    data = cls(events, "userid", "movieid", "rating", seed=0,
               verbose=False)
    data.warm_start = warm_start
    data.holdout_size = 1
    data.prepare()
    return data


@pytest.fixture(scope="module")
def known():
    return _data(JaxData, False), _data(TorchData, False)


@pytest.fixture(scope="module")
def warm():
    return _data(JaxData, True), _data(TorchData, True)


def _model(cls, data, f64=False, **attrs):
    if cls is JaxCoffee or cls is JaxSVD:
        model = cls(data)
        if f64:
            model.compute_dtype = jnp.float64
    else:
        model = cls(data, device="cpu")
        if f64:
            model.compute_dtype = torch.float64
    model.verbose = False
    for name, value in attrs.items():
        setattr(model, name, value)
    return model


def _factor_shapes(data, mlrank=MLRANK):
    userid, itemid, feedback = data.fields
    n_users = data.training[userid].max() + 1
    n_items = data.training[itemid].max() + 1
    n_levels = data.training[feedback].nunique()
    return {userid: (n_users, mlrank[0]), itemid: (n_items, mlrank[1]),
            feedback: (n_levels, mlrank[2]), "core": mlrank}


def _dyadic(shapes, seed):
    rs = np.random.RandomState(seed)
    return {name: np.round(rs.randn(*shape) * 4) / 4
            for name, shape in shapes.items()}


def _jax_start(data, mlrank=MLRANK, seed=0):
    """The JAX package's seeded HOOI start for this data's tensor, as
    numpy (``polara_tpu/ops/hooi.py:130-133``)."""
    _, _, shape = data.to_coo(tensor_mode=True)
    k1, k2 = jax.random.split(jax.random.key(seed))
    return tuple(np.asarray(jnp.linalg.qr(jax.random.uniform(
        k, (n, r), jnp.float64))[0])
        for k, n, r in ((k1, shape[1], mlrank[1]), (k2, shape[2], mlrank[2])))


def _with_fused_plain(fn):
    """Run ``fn`` with the fused route forced (its plain version on the
    CPU) in catalog item order, so equal scores go to the lower id."""
    saved = {name: tconfig.get_default(name)
             for name in ("fused_scoring", "fused_item_order")}
    try:
        tconfig.set_default("fused_scoring", True)
        tconfig.set_default("fused_item_order", None)
        return fn()
    finally:
        for name, value in saved.items():
            tconfig.set_default(name, value)


@pytest.mark.parametrize("scenario", ["known", "warm"])
def test_carried_factors_give_jax_recommendations(request, scenario):
    """Dyadic factors carried across with ``factors_from_jax`` into a port
    model that was never built (``set_factors`` makes the feedback-level
    index): ids identical through the unfused route and through the fused
    route's plain version; ``predict_feedback`` equal (known users)."""
    jdata, tdata = _data(JaxData, scenario == "warm"), \
        _data(TorchData, scenario == "warm")
    factors = _dyadic(_factor_shapes(jdata), seed=1)
    ref = _model(JaxCoffee, jdata, mlrank=MLRANK)
    ref.factors = {k: jnp.asarray(v, jnp.float32) for k, v in factors.items()}
    ref._is_ready = True
    jdata.to_coo(tensor_mode=True)          # the JAX feedback index
    want = ref.recommendations

    port = _model(CoffeeModel, tdata, mlrank=MLRANK)
    assert tdata.index.feedback is None
    port.set_factors(factors_from_jax(factors, device="cpu"))
    np.testing.assert_array_equal(port.recommendations, want)

    def fused():
        port._recommendations = None
        assert port.uses_fused_scoring(port.score_params())
        return port.recommendations
    np.testing.assert_array_equal(_with_fused_plain(fused), want)
    if scenario == "known":
        np.testing.assert_array_equal(port.predict_feedback(),
                                      ref.predict_feedback())


def test_set_factors_checks_the_feedback_levels(known):
    _, tdata = known
    factors = _dyadic(_factor_shapes(tdata), seed=2)
    feedback = tdata.fields.feedback
    factors[feedback] = factors[feedback][:-1]
    with pytest.raises(ValueError, match="feedback levels"):
        _model(CoffeeModel, tdata).set_factors(
            factors_from_jax(factors, device="cpu"))


@pytest.fixture(scope="module")
def jax_build(known):
    """A JAX f64 build from its seeded start (5 sweeps) and its factors
    as numpy."""
    jdata, tdata = known
    start = _jax_start(jdata)
    model = _model(JaxCoffee, jdata, f64=True, mlrank=MLRANK, num_iters=5,
                   init_factors=start)
    model.build()
    factors = {k: np.asarray(v) for k, v in model.factors.items()}
    return start, factors


def _carried(data, factors, cls=CoffeeModel):
    model = _model(cls, data, f64=True, mlrank=MLRANK)
    model.set_factors(factors_from_jax(factors, device="cpu",
                                       dtype=torch.float64))
    return model


def _jax_carried(data, factors):
    model = _model(JaxCoffee, data, f64=True, mlrank=MLRANK)
    model.factors = {k: jnp.asarray(v) for k, v in factors.items()}
    model._is_ready = True
    return model


def test_mlrank_reduction_rounds_the_core_like_jax(known, jax_build):
    """Lowering the mlrank rotates the factors through the rounded core in
    both packages: factors and core within 1e-12 (f64); raising it past
    the built rank drops the factors."""
    jdata, tdata = known
    _, factors = jax_build
    ref, port = _jax_carried(jdata, factors), _carried(tdata, factors)
    for model in (ref, port):
        model.mlrank = (4, 3, 2)
        assert model._is_ready
    for name, want in ref.factors.items():
        got = port.factors[name].numpy()
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-12, err_msg=name)
    port.mlrank = (8, 3, 2)
    assert not port._is_ready and port.factors == {}


def test_f64_build_matches_jax(known, jax_build):
    """The port's own build from the JAX start (f64, 5 sweeps) against the
    JAX build: top-10 overlap >= 0.99 and |dHR@10| <= 1e-6."""
    jdata, tdata = known
    start, factors = jax_build
    ref = _jax_carried(jdata, factors)
    port = _model(CoffeeModel, tdata, f64=True, mlrank=MLRANK, num_iters=5,
                  init_factors=start)
    port.build()
    assert len(port.growth_history) == 5
    want, got = ref.recommendations, port.recommendations
    overlap = np.mean([len(set(a) & set(b)) / len(a)
                       for a, b in zip(want, got)])
    assert overlap >= 0.99
    hr_want = ref.evaluate("relevance").hr
    assert abs(port.evaluate("relevance").hr - hr_want) <= 1e-6


def test_find_optimal_tucker_ranks_matches_jax(known, jax_build):
    """The rank search from the same (6, 5, 2) factors over a grid with
    cells of every kind (core rounding on one mode, on two, none): the
    same best mlrank and scores within 1e-9."""
    jdata, tdata = known
    _, factors = jax_build
    grid = ((4, 6), (3, 5), (2,))
    kw = dict(return_scores=True, metric_type="relevance")
    best_j, scores_j = jax_tucker_ranks(_jax_carried(jdata, factors), grid,
                                        "hr", **kw)
    model = _carried(tdata, factors)
    best, scores = find_optimal_tucker_ranks(model, grid, "hr", **kw)
    assert tuple(best) == tuple(best_j)
    assert list(scores.index) == list(scores_j.index)
    np.testing.assert_allclose(scores.values, scores_j.values, rtol=0,
                               atol=1e-9)
    # the max-rank factors are restored for the next sweep
    assert model.mlrank == MLRANK
    assert model.factors["core"].shape == MLRANK


def test_dense_tier_is_cached_and_the_coo_tier_agrees(known):
    """Within the budget the dense tensor is built once and cached on the
    data object under ("coffee_tensor", dtype, device); past it the build
    takes the event tier: principal angles < 1e-10 between the tiers'
    factors (f64, one seed)."""
    _, tdata = known
    dense = _model(CoffeeModel, tdata, f64=True, mlrank=MLRANK, num_iters=4,
                   seed=0)
    dense.build()
    cache = tdata.__dict__["_device_matrix_cache"]
    key = ("coffee_tensor", torch.float64, torch.device("cpu"))
    tensor = cache[key]
    dense.build()
    assert cache[key] is tensor
    saved = tconfig.get_default("hbm_score_budget_gb")
    try:
        tconfig.set_default("hbm_score_budget_gb", 1e-9)
        coo = _model(CoffeeModel, tdata, f64=True, mlrank=MLRANK,
                     num_iters=4, seed=0)
        coo.build()
    finally:
        tconfig.set_default("hbm_score_budget_gb", saved)
    for name in tdata.fields:
        q1 = np.linalg.qr(dense.factors[name].numpy())[0]
        q2 = np.linalg.qr(coo.factors[name].numpy())[0]
        assert np.linalg.norm(q2 - q1 @ (q1.T @ q2), 2) < 1e-10


@pytest.mark.parametrize("order", ["svd_first", "coffee_first"])
def test_plans_of_tensor_and_matrix_models_stay_apart(order):
    """An ``SVDModel`` and a ``CoffeeModel`` on one data object, scored in
    either order: each gets its own test plan (CoFFee's holds feedback
    levels, PureSVD's ratings) and the JAX package's recommendations
    (dyadic factors)."""
    jdata, tdata = _data(JaxData, False), _data(TorchData, False)
    coffee_factors = _dyadic(_factor_shapes(jdata), seed=3)
    jc = _model(JaxCoffee, jdata, mlrank=MLRANK)
    jc.factors = {k: jnp.asarray(v, jnp.float32)
                  for k, v in coffee_factors.items()}
    jc._is_ready = True
    jdata.to_coo(tensor_mode=True)
    js = _model(JaxSVD, jdata)
    js.rank = 5
    userid, itemid, _ = jdata.fields
    svd_factors = {itemid: np.linalg.qr(np.random.RandomState(4).randn(
        _factor_shapes(jdata)[itemid][0], 5))[0], userid: None,
        "singular_values": np.ones(5)}
    svd_factors[itemid] = np.round(svd_factors[itemid] * 8) / 8
    js.factors = {k: None if v is None else jnp.asarray(v, jnp.float32)
                  for k, v in svd_factors.items()}
    js._is_ready = True
    want = {"svd": js.recommendations, "coffee": jc.recommendations}

    tc = _model(CoffeeModel, tdata, mlrank=MLRANK)
    tc.set_factors(factors_from_jax(coffee_factors, device="cpu"))
    ts = _model(SVDModel, tdata)
    ts.rank = 5
    ts.set_factors(factors_from_jax(svd_factors, device="cpu"))
    models = {"svd": ts, "coffee": tc}
    names = ["svd", "coffee"] if order == "svd_first" else ["coffee", "svd"]
    for name in names:
        np.testing.assert_array_equal(models[name].recommendations,
                                      want[name], err_msg=name)
    plans = tdata.__dict__["_test_plan_cache"]
    assert len(plans) == 2
    n_levels = tdata.index.feedback.shape[0]
    coffee_plan = tc._test_plan
    assert coffee_plan is not ts._test_plan
    levels = torch.cat([c.vals[c.valid] for c in coffee_plan.chunks])
    assert levels.max() < n_levels


def test_mesh_build_and_scoring(known):
    """``CoffeeModel(mesh=...)``: the (4, 1) build runs ``distributed_hooi``
    (principal angles < 1e-6 against one device, f64, one seed); with one
    device's factors, the (4, 1) and (2, 2) meshes give one device's ids
    on the unfused route and on the fused route's plain version."""
    _, tdata = known
    single = _model(CoffeeModel, tdata, f64=True, mlrank=MLRANK,
                    num_iters=4, seed=0)
    single.build()
    mesh41 = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    mesh22 = make_mesh(devices=["cpu"] * 4, shape=(2, 2))
    dist = _model(CoffeeModel, tdata, f64=True, mlrank=MLRANK, num_iters=4,
                  seed=0)
    dist.mesh = mesh41
    dist.build()
    for name in tdata.fields:
        q1 = np.linalg.qr(single.factors[name].numpy())[0]
        q2 = np.linalg.qr(dist.factors[name].numpy())[0]
        assert np.linalg.norm(q2 - q1 @ (q1.T @ q2), 2) < 1e-6
    want = single.recommendations
    want_fused = _with_fused_plain(lambda: (
        setattr(single, "_recommendations", None),
        single.recommendations)[1])
    fixed = {k: v.clone() for k, v in single.factors.items()}
    for mesh in (mesh41, mesh22):
        model = _model(CoffeeModel, tdata, f64=True, mlrank=MLRANK)
        model.mesh = mesh
        model.set_factors(fixed)
        np.testing.assert_array_equal(model.recommendations, want)
        model._recommendations = None
        np.testing.assert_array_equal(
            _with_fused_plain(lambda: model.recommendations), want_fused)
