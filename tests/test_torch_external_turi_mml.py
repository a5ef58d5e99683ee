"""The port's Turi and MyMediaLite adapters against the fake
``turicreate`` module and the fake ``item_recommendation`` CLI of the JAX
package's contract tests: the cases of
``tests/test_external_contract_turi_mml.py`` on the port (CPU), and the
port against the JAX package on the same fake backends and data."""
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import _fake_mml
import _fake_turicreate

tc_mod = _fake_turicreate.install()
pytestmark = pytest.mark.skipif(
    "fake" not in str(getattr(tc_mod, "__version__", "")),
    reason="real turicreate installed; contract tests target the fake")

from polara_tpu.data import RecommenderData as JaxData  # noqa: E402
from polara_tpu.data.coldstart import (  # noqa: E402
    ItemColdStartData as JaxColdData)
from polara_tpu.models.external.mymedialite import (  # noqa: E402
    MyMediaLiteWrapper as JaxMML)
from polara_tpu.models.external.turi import (  # noqa: E402
    TuriColdStartRecommender as JaxTuriColdStart,
    TuriFactorizationRecommender as JaxTuri)
from polara_tpu_torch.data import RecommenderData  # noqa: E402
from polara_tpu_torch.data.coldstart import ItemColdStartData  # noqa: E402
from polara_tpu_torch.models.external.mymedialite import (  # noqa: E402
    MyMediaLiteWrapper)
from polara_tpu_torch.models.external.turi import (  # noqa: E402
    TuriColdStartRecommender, TuriFactorizationRecommender)

N_USERS, N_ITEMS = 40, 25
GENRES = ["action", "comedy", "drama", "horror"]


def make_events(seed=0):
    rs = np.random.RandomState(seed)
    rows = []
    for user in range(N_USERS):
        items = rs.choice(N_ITEMS, size=rs.randint(6, 12), replace=False)
        for item in items:
            rows.append((user, item, rs.randint(1, 6)))
    return pd.DataFrame(rows, columns=["userid", "movieid", "rating"])


def make_features(seed=1):
    rs = np.random.RandomState(seed)
    return pd.DataFrame(
        {"genres": [",".join(sorted(rs.choice(
            GENRES, size=rs.randint(1, 3), replace=False)))
            for _ in range(N_ITEMS)]},
        index=pd.RangeIndex(N_ITEMS, name="movieid"))


def _known_user_data(cls=RecommenderData):
    data = cls(make_events(), "userid", "movieid", "rating", seed=0,
               verbose=False)
    data.warm_start = False
    data.holdout_size = 2
    data.prepare()
    return data


def _cold_data(cls=ItemColdStartData, test_sample=None):
    data = cls(make_events(), "userid", "movieid", "rating",
               item_features=make_features(), seed=0, verbose=False)
    if test_sample is not None:
        data.test_sample = test_sample
    data.prepare()
    return data


def _port(cls, data, **kwargs):
    model = cls(data, device="cpu", **kwargs)
    model.verbose = False
    return model


@pytest.fixture
def known_user_data():
    return _known_user_data()


@pytest.fixture(autouse=True)
def clean_journal():
    _fake_turicreate.FakeTuriModel.reset_journal()
    yield


def _journal(call):
    return [c for c in _fake_turicreate.FakeTuriModel.calls
            if c["call"] == call]


# --------------------------------------------------------------------------
# Turi
# --------------------------------------------------------------------------

def test_turi_build_and_recommend_contract(known_user_data):
    model = _port(TuriFactorizationRecommender, known_user_data)
    model.rank = 6
    model.build()

    (create,) = _journal("create")
    assert create["kind"] == "factorization"
    assert create["params"]["num_factors"] == 6
    assert create["params"]["target"] == "rating"
    assert create["params"]["side_data_factorization"] is True
    assert create["item_data_ids"] is None
    assert create["n_train"] == len(known_user_data.training)

    recs = model.recommendations
    n_test_users = known_user_data.test.holdout["userid"].nunique()
    assert recs.shape == (n_test_users, model.topk)
    (rec_call,) = _journal("recommend")
    assert rec_call["exclude_known"] is True
    assert rec_call["n_users"] == n_test_users

    model.filter_seen = False
    model.recommendations
    assert _journal("recommend")[-1]["exclude_known"] is False


def test_turi_side_info_remapped_to_internal_ids(known_user_data):
    features = make_features()
    model = _port(TuriFactorizationRecommender, known_user_data,
                  item_side_info=features)
    model.build()

    (create,) = _journal("create")
    item_index = known_user_data.index.itemid
    item_index = getattr(item_index, "training", item_index)
    assert sorted(create["item_data_ids"]) == \
        sorted(item_index["new"].tolist())
    assert "genres" in create["item_data_columns"]
    frame = model.item_data.to_dataframe()
    back = item_index.set_index("new")["old"]
    for _, row in frame.iloc[:5].iterrows():
        original = back.loc[row["movieid"]]
        assert row["genres"] == features.loc[original, "genres"]


def test_turi_ranking_variant_and_rmse(known_user_data):
    model = _port(TuriFactorizationRecommender, known_user_data)
    model.ranking_optimization = True
    model.build()
    (create,) = _journal("create")
    assert create["kind"] == "ranking_factorization"
    assert create["params"]["ranking_regularization"] == 0.25
    assert create["params"]["num_sampled_negative_examples"] == 4

    rmse = model.evaluate_rmse()
    assert np.isfinite(rmse) and rmse >= 0
    (rmse_call,) = _journal("evaluate_rmse")
    assert rmse_call["n"] == len(known_user_data.test.holdout)


def test_turi_cold_start_new_item_data_plumbing():
    data = _cold_data()
    model = _port(TuriColdStartRecommender, data,
                  item_side_info=make_features())
    model.build()
    recs = model.recommendations

    n_cold = data.index.itemid.cold_start.shape[0]
    assert recs.shape == (n_cold, model.topk)
    known_users = set(data.index.userid.training["new"])
    assert set(np.unique(recs)) <= known_users

    (predict,) = _journal("predict")
    lower = data.index.itemid.training["new"].max() + 1
    assert min(predict["new_item_ids"]) == lower
    assert len(predict["new_item_ids"]) == n_cold
    assert predict["new_item_columns"] == ["genres"]
    n_repr = data.index.userid.training.shape[0]
    assert predict["n_pairs"] == n_cold * n_repr


def test_turi_cold_start_pads_small_candidate_pool():
    data = _cold_data(test_sample=2)     # 2 representative users < topk
    model = _port(TuriColdStartRecommender, data,
                  item_side_info=make_features())
    model.topk = 5
    model.build()
    recs = model.recommendations
    n_cold = data.index.itemid.cold_start.shape[0]
    assert recs.shape == (n_cold, 5)
    assert (recs[:, 2:] == -1).all()
    assert (recs[:, :2] >= 0).all()


def test_turi_side_info_reassignment_invalidates_sframe_cache():
    data = _cold_data()
    features = make_features()
    model = _port(TuriColdStartRecommender, data, item_side_info=features)
    first = model.item_data
    assert first is model.item_data          # cached while unchanged
    model.item_side_info = features.copy()
    assert model.item_data is not first      # rebuilt from the new frame


# --------------------------------------------------------------------------
# MyMediaLite
# --------------------------------------------------------------------------

@pytest.fixture
def mml_dirs(tmp_path):
    library = _fake_mml.install(tmp_path / "mml")
    data_folder = tmp_path / "artifacts"
    data_folder.mkdir()
    return library, str(data_folder)


def _mml_model(data, dirs, method="BPRMF", cls=MyMediaLiteWrapper,
               **attrs):
    library, folder = dirs
    data.name = "testdata"
    model = (cls(library, folder, method, data, device="cpu")
             if cls is MyMediaLiteWrapper
             else cls(library, folder, method, data))
    model.verbose = False
    model.rank = 4
    for key, value in attrs.items():
        setattr(model, key, value)
    return model


def test_mml_cli_round_trip_and_factor_placement(known_user_data,
                                                 mml_dirs):
    model = _mml_model(known_user_data, mml_dirs, method="WRMF",
                       orthogonal_factors=False, feedback_threshold=1)
    model.build()

    u = model.factors["userid"].numpy()
    v = model.factors["movieid"].numpy()
    n_users = known_user_data.index.userid.training["new"].max() + 1
    item_index = known_user_data.index.itemid
    item_index = getattr(item_index, "training", item_index)
    n_items = item_index["new"].max() + 1
    assert u.shape == (n_users, 4) and v.shape == (n_items, 4)
    assert model.factors["movieid"].device.type == "cpu"
    for uid in (0, 1, n_users - 1):
        np.testing.assert_allclose(
            u[uid], uid + np.arange(4) / 100, atol=1e-9)
    for iid in (0, n_items - 1):
        np.testing.assert_allclose(
            v[iid], 2 * iid + np.arange(4) / 100, atol=1e-9)
    assert model._items_biases is None


def test_mml_biases_parsed_and_scattered(known_user_data, mml_dirs):
    model = _mml_model(known_user_data, mml_dirs, method="BPRMF",
                       orthogonal_factors=False, feedback_threshold=1)
    model.build()
    item_index = known_user_data.index.itemid
    item_index = getattr(item_index, "training", item_index)
    n_items = item_index["new"].max() + 1
    biases = model._items_biases
    assert biases is not None and biases.shape == (n_items,)
    np.testing.assert_allclose(biases, 1000 + np.arange(n_items),
                               atol=1e-9)


def test_mml_orthogonalized_folding_and_recommendations(known_user_data,
                                                        mml_dirs):
    model = _mml_model(known_user_data, mml_dirs, method="BPRMF",
                       feedback_threshold=1)
    assert model.orthogonal_factors    # default: QR fold-in
    model.build()
    v = model.factors["movieid"].numpy()
    np.testing.assert_allclose(v.T @ v, np.eye(v.shape[1]), atol=1e-5)

    recs = model.recommendations
    n_test_users = known_user_data.test.holdout["userid"].nunique()
    assert recs.shape == (n_test_users, model.topk)
    assert (recs >= 0).all() and (recs < v.shape[0]).all()


def test_mml_no_id_mapping_path(known_user_data, mml_dirs):
    model = _mml_model(known_user_data, mml_dirs, method="WRMF",
                       orthogonal_factors=False, positive_only=False,
                       feedback_threshold=1)
    assert "--no-id-mapping" in model._run_external(debug=True)
    model.build()
    u = model.factors["userid"].numpy()
    n_users = known_user_data.index.userid.training["new"].max() + 1
    assert u.shape == (n_users, 4)
    np.testing.assert_allclose(u[2], 2 + np.arange(4) / 100, atol=1e-9)


def test_mml_external_failure_raises(known_user_data, tmp_path):
    data_folder = tmp_path / "artifacts"
    data_folder.mkdir()
    known_user_data.name = "testdata"
    model = MyMediaLiteWrapper(str(tmp_path / "missing"),
                               str(data_folder), "BPRMF",
                               known_user_data, device="cpu")
    model.verbose = False
    with pytest.raises((ValueError, OSError)):
        model.build()


# --------------------------------------------------------------------------
# the port against the JAX package on the same fake backends
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ranking", [False, True])
def test_turi_recommendations_equal_the_jax_package(ranking):
    features = make_features()
    models = []
    for cls, data in ((JaxTuri, _known_user_data(JaxData)),
                      (TuriFactorizationRecommender, _known_user_data())):
        model = (cls(data, item_side_info=features) if cls is JaxTuri
                 else cls(data, item_side_info=features, device="cpu"))
        model.verbose = False
        model.ranking_optimization = ranking
        models.append(model)
    ref, port = models
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)
    assert port.evaluate_rmse() == ref.evaluate_rmse()


@pytest.mark.parametrize("test_sample", [None, 2])
def test_turi_cold_start_equals_the_jax_package(test_sample):
    ref = JaxTuriColdStart(_cold_data(JaxColdData, test_sample),
                           item_side_info=make_features())
    port = _port(TuriColdStartRecommender, _cold_data(
        test_sample=test_sample), item_side_info=make_features())
    for model in (ref, port):
        model.verbose = False
        model.topk = 5
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)


@pytest.mark.parametrize("method,positive_only", [("WRMF", True),
                                                  ("BPRMF", True),
                                                  ("WRMF", False)])
def test_mml_factors_and_picks_equal_the_jax_package(tmp_path, method,
                                                     positive_only):
    """Parsed and remapped factors equal exactly; the QR-folded ones (both
    host f64, then f32) within 1e-6; picks equal except rows whose f64
    scores tie within 1e-6 of the row scale (f32 products in another
    order), which are counted and held to that by re-scoring."""
    built = []
    for cls, data_cls, sub in ((JaxMML, JaxData, "jax"),
                               (MyMediaLiteWrapper, RecommenderData,
                                "torch")):
        dirs = (_fake_mml.install(tmp_path / sub / "mml"),
                str(tmp_path / sub))
        model = _mml_model(_known_user_data(data_cls), dirs, method=method,
                           cls=cls, positive_only=positive_only,
                           feedback_threshold=1, orthogonal_factors=False)
        model.build()
        raw = {k: np.asarray(model.factors[k]) if cls is JaxMML
               else model.factors[k].numpy() for k in ("userid", "movieid")}
        model.orthogonal_factors = True
        model.build()
        built.append((model, raw))
    (ref, ref_raw), (port, port_raw) = built
    for key in ("userid", "movieid"):
        np.testing.assert_array_equal(port_raw[key], ref_raw[key])
        np.testing.assert_allclose(port.factors[key].numpy(),
                                   np.asarray(ref.factors[key]), rtol=0,
                                   atol=1e-6)
    if method == "BPRMF":
        np.testing.assert_array_equal(port._items_biases, ref._items_biases)
    got, want = port.recommendations, ref.recommendations
    differ = np.flatnonzero((got != want).any(axis=1))
    profiles, _ = port.get_test_matrix()
    v = torch.as_tensor(np.array(ref.factors["movieid"]),
                        dtype=torch.float64)
    scores = (profiles.double() @ v @ v.T).numpy()
    for row in differ:
        s = scores[row]
        gap = np.abs(s[got[row]] - s[want[row]]).max()
        assert gap <= 1e-6 * np.abs(s).max(), (row, gap)
    print(f"{method}: {differ.size} of {len(got)} rows differ within ties")


def test_turi_construction_without_turicreate_raises(known_user_data,
                                                     monkeypatch):
    monkeypatch.setitem(sys.modules, "turicreate", None)
    with pytest.raises(ImportError, match="turicreate"):
        TuriFactorizationRecommender(known_user_data, device="cpu")
