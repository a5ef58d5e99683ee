"""The slice end to end: the port's ``SVDModel`` on the data model, against
``polara_tpu``'s on the ``conftest.py`` fixtures (CPU, unfused path under
the default ``fused_scoring="auto"``)."""
import numpy as np
import pytest
import torch

from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.models import SVDModel as TorchSVD
from polara_tpu_torch.ops.scoring import run_scores_only
from polara_tpu_torch.runtime.convert import factors_from_jax

RANK = 5


def _pair(frame, **config):
    out = []
    for cls in (JaxData, TorchData):
        data = cls(frame.copy(), "userid", "movieid", "rating", seed=0,
                   verbose=False)
        for name, value in config.items():
            setattr(data, name, value)
        data.prepare()
        out.append(data)
    return out


def _model(cls, data, rank=RANK):
    model = cls(data, device="cpu") if cls is TorchSVD else cls(data)
    model.verbose = False
    model.rank = rank
    return model


def _jax_factors(model):
    return {k: None if v is None else np.asarray(v)
            for k, v in model.factors.items()}


def _assert_metrics_close(got, want, atol):
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for name, wv in w._asdict().items():
            gv = getattr(g, name)
            if wv is None:
                assert gv is None, name
            else:
                np.testing.assert_allclose(gv, wv, rtol=0, atol=atol,
                                           err_msg=name)


@pytest.mark.parametrize("config", [dict(), dict(warm_start=False,
                                                 holdout_size=1)])
def test_carried_factors_give_identical_recommendations(
        synthetic_interactions, config):
    """JAX factors carried over with factors_from_jax: identical ids and
    evaluate() within 1e-6 (the metrics see identical ids; the bound
    covers f64 summation order)."""
    jdata, tdata = _pair(synthetic_interactions, **config)
    ref = _model(JaxSVD, jdata)
    want = ref.recommendations
    port = TorchSVD(tdata, device="cpu")
    port.verbose = False
    port.set_factors(factors_from_jax(_jax_factors(ref), device="cpu"))
    np.testing.assert_array_equal(port.recommendations, want)
    _assert_metrics_close(port.evaluate(), ref.evaluate(), atol=1e-6)


def test_self_built_model_matches_jax(synthetic_interactions):
    """The port builds its own factors: singular values within 1e-4
    relative (f32 solves from different random starts), and the same
    recommendations up to ties within 1e-6 of the row scale."""
    jdata, tdata = _pair(synthetic_interactions)
    ref = _model(JaxSVD, jdata)
    want = ref.recommendations
    port = _model(TorchSVD, tdata)
    got = port.recommendations
    np.testing.assert_allclose(port.factors["singular_values"].numpy(),
                               np.asarray(ref.factors["singular_values"]),
                               rtol=1e-4)
    differ = np.flatnonzero((got != want).any(axis=1))
    if differ.size:     # re-score with the reference factors
        v = torch.as_tensor(np.asarray(ref.factors["movieid"]))
        scores = run_scores_only(port._test_plan, TorchSVD.score_chunk,
                                 {"item_factors": v, "item_panel": v})
        for row in differ:
            s = scores[row]
            gap = np.abs(s[got[row]] - s[want[row]]).max()
            assert gap <= 1e-6 * np.abs(s).max(), (row, gap)


def test_fused_scoring_forced_on_cpu_equals_unfused():
    """fused_scoring=True on the CPU runs the kernel's plain version and
    must give the unfused path's recommendations (as
    tests/test_pallas.py checks for the Pallas route)."""
    events = make_synthetic_interactions(n_users=50, n_items=30,
                                         n_events=800, seed=0)
    _, data = _pair(events, warm_start=False, test_ratio=0, holdout_size=2)
    model = _model(TorchSVD, data, rank=6)
    saved = tconfig.get_default("fused_scoring")
    try:
        tconfig.set_default("fused_scoring", False)
        unfused = model.recommendations.copy()
        tconfig.set_default("fused_scoring", True)
        model._recommendations = None
        assert model.uses_fused_scoring(model.score_params())
        fused = model.recommendations
    finally:
        tconfig.set_default("fused_scoring", saved)
    np.testing.assert_array_equal(fused, unfused)


@pytest.mark.parametrize("dyadic", [True, False])
def test_segment_sum_projection_equals_the_index_add_route(dyadic):
    """``SVDModel.proj_chunk`` and the COO operator's products run as sorted
    segment sums (bit-reproducible on the card); on the CPU they equal the
    ``index_add_`` route they replaced: identical for dyadic values
    (exact sums in any order), and within rtol 1e-6 of each row's (or
    column's) largest magnitude for Gaussian ones (f32 sums in another
    order)."""
    from polara_tpu_torch.ops.scoring import ChunkedTestData
    from polara_tpu_torch.ops.sparse import CooMatrix
    rs = np.random.RandomState(0)
    n_users, n_items, rank = 70, 50, 8
    pairs = np.unique(np.stack([rs.randint(0, n_users, 900),
                                rs.randint(0, n_items, 900)], 1), axis=0)
    vals = (np.round(rs.randn(len(pairs)) * 4) / 4 if dyadic
            else rs.randn(len(pairs))).astype(np.float32)
    v = torch.as_tensor(np.round(rs.randn(n_items, rank) * 4) / 4 if dyadic
                        else rs.randn(n_items, rank), dtype=torch.float32)
    plan = ChunkedTestData.build(pairs[:, 0], pairs[:, 1], vals, n_users,
                                 n_items, chunk_users=32, device="cpu")

    def index_add_route(rows, cols, w, x, n_out):
        out = torch.zeros((n_out, x.shape[1]))
        return out.index_add_(0, rows, w[:, None] * x[cols])

    def check(got, want):
        if dyadic:
            assert torch.equal(got, want)
        else:
            scale = want.abs().amax(dim=1, keepdim=True)
            assert ((got - want).abs() <= 1e-6 * scale).all()

    for chunk in plan.chunks:
        want = index_add_route(chunk.rows, chunk.cols,
                               torch.where(chunk.valid, chunk.vals, 0.0), v,
                               chunk.users.shape[0])
        check(TorchSVD.proj_chunk({"item_factors": v}, chunk), want)
    coo = CooMatrix.from_numpy(pairs[:, 0], pairs[:, 1], vals,
                               (n_users, n_items), device="cpu")
    u = torch.as_tensor(np.round(rs.randn(n_users, rank) * 4) / 4 if dyadic
                        else rs.randn(n_users, rank), dtype=torch.float32)
    op = coo.operator()
    check(op.mm(v), index_add_route(coo.rows, coo.cols, coo.vals, v,
                                    n_users))
    check(op.rmm(u), index_add_route(coo.cols, coo.rows, coo.vals, u,
                                     n_items))
