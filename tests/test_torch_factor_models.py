"""The factor models of the port (``ImplicitALS``, ``ImplicitBPR``) through
the data model, and the mesh trainers (``distributed_ials``,
``distributed_bpr``), against ``polara_tpu`` and against the port's own
single-device trainers on the CPU; each tolerance stated with its test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu.models import ImplicitALS as JaxALS
from polara_tpu.models import ImplicitBPR as JaxBPR
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.models import ImplicitALS as TorchALS
from polara_tpu_torch.models import ImplicitBPR as TorchBPR
from polara_tpu_torch.models import ProbabilisticMF as TorchPMF
from polara_tpu_torch.ops import implicit as ti
from polara_tpu_torch.parallel import distributed_bpr, distributed_ials
from polara_tpu_torch.runtime.convert import factors_from_jax
from polara_tpu_torch.runtime.mesh import make_mesh

RANK = 6


def _pair(warm_start):
    events = make_synthetic_interactions(n_users=80, n_items=40,
                                         n_events=1600, seed=0)
    out = []
    for cls in (JaxData, TorchData):
        data = cls(events.copy(), "userid", "movieid", "rating", seed=0,
                   verbose=False)
        data.warm_start = warm_start
        data.holdout_size = 1
        data.prepare()
        out.append(data)
    return out


@pytest.fixture(scope="module")
def known():
    return _pair(warm_start=False)


@pytest.fixture(scope="module")
def warm():
    return _pair(warm_start=True)


def _model(cls, data, **attrs):
    model = cls(data, device="cpu") if cls.__module__.startswith(
        "polara_tpu_torch") else cls(data)
    model.verbose = False
    model.rank = RANK
    for name, value in attrs.items():
        setattr(model, name, value)
    return model


def _dyadic_factors(model, seed):
    """The model's factor shapes filled with multiples of 1/4: every
    known-user score is exact in f32 in both packages."""
    rs = np.random.RandomState(seed)
    return {name: np.round(rs.randn(*np.asarray(v).shape) * 4) / 4
            for name, v in model.factors.items()}


@pytest.mark.parametrize("jcls,tcls,attrs", [
    (JaxALS, TorchALS, dict(num_epochs=2)),
    (JaxBPR, TorchBPR, dict(num_epochs=2, batch_size=128)),
])
@pytest.mark.parametrize("scenario", ["known", "warm"])
def test_carried_factors_give_jax_recommendations(request, jcls, tcls,
                                                  attrs, scenario):
    """The JAX model's (dyadic) factors carried across with
    ``factors_from_jax``: identical recommendations for known users (the
    unfused route, and the fused route's plain version forced in catalog
    item order) and for warm-start users (the port's fold-in solve, then
    ``mask_and_topk``)."""
    jdata, tdata = request.getfixturevalue(scenario)
    ref = _model(jcls, jdata, **attrs)
    ref.build()
    factors = _dyadic_factors(ref, seed=1)
    ref.factors = {k: jnp.asarray(v, jnp.float32) for k, v in factors.items()}
    want = ref.recommendations
    port = _model(tcls, tdata, **attrs)
    port.set_factors(factors_from_jax(factors, device="cpu"))
    np.testing.assert_array_equal(port.recommendations, want)
    if scenario == "known":
        # catalog order, so equal scores go to the lower id in both routes
        saved = {name: tconfig.get_default(name)
                 for name in ("fused_scoring", "fused_item_order")}
        try:
            tconfig.set_default("fused_scoring", True)
            tconfig.set_default("fused_item_order", None)
            port._recommendations = None
            assert port.uses_fused_scoring(port.score_params())
            np.testing.assert_array_equal(port.recommendations, want)
        finally:
            for name, value in saved.items():
                tconfig.set_default(name, value)


def test_self_built_ials_metrics_match_jax(known):
    """Each package builds iALS from its own start (different draws): HR@10
    averaged over two seeds within 0.1 (a fold of 16 users with one
    held-out item: one hit is 0.0625)."""
    jdata, tdata = known
    hr = {}
    for cls, data in ((JaxALS, jdata), (TorchALS, tdata)):
        hr[cls] = np.mean([_model(cls, data, num_epochs=5, seed=s)
                           .evaluate("relevance").hr for s in (0, 1)])
    assert abs(hr[TorchALS] - hr[JaxALS]) <= 0.1, hr


def test_ials_routes_to_the_event_tier_past_the_budget(known):
    """A budget below the dense block's bytes routes the build to
    ``ials_train_events``: the factors are that function's on the same
    events, bit for bit (CPU), and within rtol 1e-4 of the dense tier's."""
    _, tdata = known
    dense_model = _model(TorchALS, tdata, num_epochs=3)
    dense_model.build()
    saved = tconfig.get_default("hbm_score_budget_gb")
    try:
        tconfig.set_default("hbm_score_budget_gb", 1e-9)
        model = _model(TorchALS, tdata, num_epochs=3)
        model.build()
    finally:
        tconfig.set_default("hbm_score_budget_gb", saved)
    coo = model.get_training_matrix()
    want = ti.ials_train_events(coo.rows, coo.cols, coo.vals, coo.shape,
                                RANK, num_epochs=3)
    assert torch.equal(model.factors["movieid"], want.item)
    assert torch.equal(model.factors["userid"], want.user)
    full = dense_model.factors["movieid"]
    assert ((want.item - full).abs()
            <= 1e-4 * full.abs().max()).all()


def test_ials_on_a_mesh_past_the_budget_raises(known):
    """Past the budget on a (4, 1) mesh the build takes the event-sharded
    ``distributed_ials_events`` (it raised until that was ported): its
    factors within 1e-4 of the largest entry of the single-device event
    tier's from the same start (f32, 3 epochs)."""
    _, tdata = known
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    saved = tconfig.get_default("hbm_score_budget_gb")
    try:
        tconfig.set_default("hbm_score_budget_gb", 1e-9)
        model = _model(TorchALS, tdata, num_epochs=3)
        model.mesh = mesh
        model.build()
    finally:
        tconfig.set_default("hbm_score_budget_gb", saved)
    coo = model.get_training_matrix()
    want = ti.ials_train_events(coo.rows, coo.cols, coo.vals, coo.shape,
                                RANK, num_epochs=3)
    for got, ref in ((model.factors["userid"], want.user),
                     (model.factors["movieid"], want.item)):
        assert ((got - ref).abs() <= 1e-4 * ref.abs().max()).all()


def test_rank_setter_resets_the_model(known):
    _, tdata = known
    model = _model(TorchBPR, tdata, num_epochs=1, batch_size=128)
    model.build()
    assert model._is_ready
    model.rank = RANK
    assert model._is_ready
    model.rank = RANK + 1
    assert not model._is_ready and model._recommendations is None


def test_pmf_warm_start_raises(warm):
    _, tdata = warm
    model = _model(TorchPMF, tdata, num_epochs=1)
    model.rank = RANK
    with pytest.raises(NotImplementedError, match="folding-in"):
        model.recommendations


@pytest.fixture(scope="module")
def ratings():
    rs = np.random.RandomState(2)
    n_users, n_items = 61, 37      # users and items pad on a (4, 1) mesh
    return ((rs.rand(n_users, n_items) < 0.3)
            * rs.randint(1, 6, (n_users, n_items))).astype(np.float64)


def test_distributed_ials_matches_single_device_epochs(ratings):
    """``distributed_ials`` on a (4, 1) CPU mesh against ``_ials_epochs``
    from the same start (f64; users pad 61 -> 64, items 37 -> 64): rtol
    1e-5."""
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    dense = torch.as_tensor(ratings)
    stats = {}
    dist = distributed_ials(dense, RANK, mesh, num_epochs=3, batch_rows=8,
                            dtype=torch.float64, train_stats=stats)
    start = ti._initial_item_factors(dense.shape[1], RANK, 0, torch.float64,
                                     "cpu")
    user, item = ti._ials_epochs(dense, torch.zeros(dense.shape[0], RANK,
                                                    dtype=torch.float64),
                                 start, 1.0, 1.0, 0.01, "log2", 3, 8, 8)
    np.testing.assert_allclose(dist.user.numpy(), user.numpy(), rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(dist.item.numpy(), item.numpy(), rtol=1e-5,
                               atol=1e-12)
    assert stats["n_devices"] == 4 and len(stats["epochs"]) == 3


def test_ials_model_on_a_mesh_routes_to_distributed_ials(known):
    """``ImplicitALS(mesh=)`` builds with ``distributed_ials``: its factors
    within rtol 1e-4 of the single-device build (f32), and its
    recommendations scored per users shard."""
    _, tdata = known
    single = _model(TorchALS, tdata, num_epochs=3)
    single.build()
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    model = _model(TorchALS, tdata, num_epochs=3)
    model.mesh = mesh
    model.build()
    for name in ("userid", "movieid"):
        want = single.factors[name]
        assert ((model.factors[name] - want).abs()
                <= 1e-4 * want.abs().max()).all(), name
    assert model.recommendations.shape == single.recommendations.shape


@pytest.fixture(scope="module")
def bpr_events(ratings):
    rows, cols = np.nonzero(ratings)
    return rows, cols, ratings.shape


def test_distributed_bpr_exact_equals_bpr_train(bpr_events):
    """The exact mode draws the single-device sampler's batches: on the
    CPU its factors and batch AUCs equal ``bpr_train``'s bit for bit."""
    rows, cols, shape = bpr_events
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    kw = dict(learning_rate=0.05, reg=0.01, num_epochs=3, batch_size=64,
              seed=0)
    single_auc, dist_auc = [], []
    single = ti.bpr_train(rows, cols, shape, RANK, device="cpu",
                          epoch_stats=single_auc, **kw)
    dist = distributed_bpr(rows, cols, shape, RANK, mesh,
                           epoch_stats=dist_auc, **kw)
    assert torch.equal(dist.user, single.user)
    assert torch.equal(dist.item, single.item)
    assert dist_auc == single_auc


def test_distributed_bpr_local_mode_learns(bpr_events):
    """Local SGD (one chain per shard, replicas averaged every 4 steps,
    which leaves a partial last block): the batch AUC rises over the
    epochs and the stats record each epoch."""
    rows, cols, shape = bpr_events
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    aucs, stats = [], {}
    distributed_bpr(rows, cols, shape, RANK, mesh, learning_rate=0.05,
                    num_epochs=12, batch_size=64, update_mode="local",
                    sync_every=4, epoch_stats=aucs, train_stats=stats)
    assert np.mean(aucs[-3:]) > np.mean(aucs[:3]) + 0.05, aucs
    assert stats["mode"] == "local" and len(stats["epochs"]) == 12


def test_distributed_bpr_rejects_bad_arguments(bpr_events):
    rows, cols, shape = bpr_events
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    with pytest.raises(ValueError, match="update_mode"):
        distributed_bpr(rows, cols, shape, RANK, mesh, update_mode="async")
    with pytest.raises(ValueError, match="divide"):
        distributed_bpr(rows, cols, shape, RANK, mesh, batch_size=66)


def test_bpr_model_on_a_mesh_equals_single_device(known):
    """``ImplicitBPR(mesh=)`` trains with ``distributed_bpr``'s exact mode:
    the single-device model's factors, bit for bit on the CPU."""
    _, tdata = known
    attrs = dict(num_epochs=2, batch_size=128)
    single = _model(TorchBPR, tdata, **attrs)
    single.build()
    model = _model(TorchBPR, tdata, **attrs)
    model.mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    model.build()
    assert torch.equal(model.factors["movieid"], single.factors["movieid"])
    assert model.epoch_stats == single.epoch_stats
