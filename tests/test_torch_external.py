"""The port's LightFM adapter (``polara_tpu_torch.models.external.lightfm``)
against the fake ``lightfm`` module of the JAX package's contract tests:
the cases of ``tests/test_external_contract.py`` on the port (CPU), and the
port's recommendations against the JAX package's on the same fake backend
and the same data."""
import sys

import numpy as np
import pandas as pd
import pytest

import _fake_lightfm

lightfm_mod = _fake_lightfm.install()
pytestmark = pytest.mark.skipif(
    "fake" not in str(getattr(lightfm_mod, "__version__", "")),
    reason="real lightfm installed; contract tests target the fake")

from polara_tpu.data import RecommenderData as JaxData  # noqa: E402
from polara_tpu.data.coldstart import (  # noqa: E402
    ItemColdStartData as JaxColdData)
from polara_tpu.models.external.lightfm import (  # noqa: E402
    LightFMItemColdStart as JaxLightFMItemColdStart,
    LightFMWrapper as JaxLightFMWrapper)
from polara_tpu_torch.data import RecommenderData  # noqa: E402
from polara_tpu_torch.data.coldstart import ItemColdStartData  # noqa: E402
from polara_tpu_torch.models.external import LightFMWrapper  # noqa: E402
from polara_tpu_torch.models.external.lightfm import (  # noqa: E402
    LightFMItemColdStart)

N_USERS, N_ITEMS = 50, 30
GENRES = ["action", "comedy", "drama", "horror"]


def make_events(seed=0):
    rs = np.random.RandomState(seed)
    rows = []
    for user in range(N_USERS):
        items = rs.choice(N_ITEMS, size=rs.randint(5, 12), replace=False)
        for item in items:
            rows.append((user, item, rs.randint(1, 6)))
    return pd.DataFrame(rows, columns=["userid", "movieid", "rating"])


def make_features(seed=1):
    rs = np.random.RandomState(seed)
    return pd.DataFrame(
        {"genres": [sorted(rs.choice(GENRES, size=rs.randint(1, 3),
                                     replace=False).tolist())
                    for _ in range(N_ITEMS)]},
        index=pd.RangeIndex(N_ITEMS))


def _known_user_data(cls=RecommenderData):
    data = cls(make_events(), "userid", "movieid", "rating", seed=0,
               verbose=False)
    data.warm_start = False
    data.holdout_size = 2
    data.prepare()
    return data


def _cold_data(cls=ItemColdStartData, test_sample=None):
    cold = cls(make_events(), "userid", "movieid", "rating", seed=0,
               verbose=False, item_features=make_features())
    if test_sample is not None:
        cold.test_sample = test_sample
    cold.prepare()
    return cold


def _port(cls, data, **kwargs):
    model = cls(data, device="cpu", **kwargs)
    model.verbose = False
    return model


@pytest.fixture
def known_user_data():
    return _known_user_data()


@pytest.fixture(autouse=True)
def clean_journal():
    _fake_lightfm.FakeLightFM.reset_journal()
    yield


def _journal(call):
    return [c for c in _fake_lightfm.FakeLightFM.calls
            if c["call"] == call]


def test_fit_contract_feature_stacking(known_user_data):
    model = _port(LightFMWrapper, known_user_data,
                  item_features=make_features())
    model.rank = 7
    model.loss = "bpr"
    model.build()

    (init,) = _journal("__init__")
    assert init["params"]["no_components"] == 7
    assert init["params"]["loss"] == "bpr"
    assert init["params"]["random_state"] == model.seed

    (fit,) = _journal("fit")
    n_items = known_user_data.index.itemid.shape[0]
    n_users = known_user_data.index.userid.training.shape[0]
    assert fit["interactions_shape"] == (n_users, n_items)
    assert fit["nnz"] == len(known_user_data.training)
    features = make_features()
    n_labels = len({g for row in features["genres"] for g in row})
    assert fit["item_features_shape"] == (n_items, n_items + n_labels)
    assert fit["item_features_shape"] == model._item_features_csr.shape
    assert fit["user_features_shape"] is None
    row_sums = np.asarray(model._item_features_csr.sum(axis=1)).ravel()
    np.testing.assert_allclose(row_sums, 1.0, rtol=1e-6)


def test_fit_partial_and_params_forwarding(known_user_data):
    model = _port(LightFMWrapper, known_user_data)
    model.fit_method = "fit_partial"
    model.fit_params = {"epochs": 3, "num_threads": 2}
    model.build()
    (fit,) = _journal("fit_partial")
    assert fit["kwargs"] == {"epochs": 3, "num_threads": 2}
    assert not _journal("fit")


def test_predict_scoring_contract(known_user_data):
    model = _port(LightFMWrapper, known_user_data,
                  item_features=make_features())
    recs = model.recommendations
    n_test_users = known_user_data.test.holdout["userid"].nunique()
    n_items = known_user_data.index.itemid.shape[0]
    assert recs.shape == (n_test_users, model.topk)

    (predict,) = _journal("predict")
    assert predict["n_pairs"] == n_test_users * n_items
    assert predict["item_features_shape"][0] == n_items

    seen = set(map(tuple, known_user_data.training[
        ["userid", "movieid"]].values.tolist()))
    test_users = np.sort(known_user_data.test.holdout["userid"].unique())
    for row, user in enumerate(test_users):
        for item in recs[row]:
            assert (user, int(item)) not in seen

    model2 = _port(LightFMWrapper, known_user_data,
                   item_features=make_features())
    np.testing.assert_array_equal(model2.recommendations, recs)


def test_warm_start_not_supported():
    data = RecommenderData(make_events(), "userid", "movieid", "rating",
                           seed=0, verbose=False)
    data.warm_start = True
    data.holdout_size = 2
    data.prepare()
    model = _port(LightFMWrapper, data)
    model.build()
    with pytest.raises(NotImplementedError):
        model.recommendations


def test_cold_start_adapter_contract():
    cold = _cold_data()
    model = _port(LightFMItemColdStart, cold, item_features=make_features())
    recs = model.recommendations

    n_cold = cold.index.itemid.cold_start.shape[0]
    n_users = cold.index.userid.training.shape[0]
    assert recs.shape == (n_cold, model.topk)
    assert ((recs >= 0) & (recs < n_users)).all()

    (predict,) = _journal("predict")
    assert predict["n_pairs"] == n_cold * n_users
    assert predict["item_features_shape"] == \
        (n_cold, model._item_features_csr.shape[1])


def test_cold_start_representative_user_mapping():
    cold = _cold_data(test_sample=12)
    model = _port(LightFMItemColdStart, cold, item_features=make_features())
    recs = model.recommendations
    candidates = set(cold.representative_users["new"].values.tolist())
    assert set(np.unique(recs).tolist()) <= candidates
    (predict,) = _journal("predict")
    n_cold = cold.index.itemid.cold_start.shape[0]
    assert predict["n_pairs"] == n_cold * len(candidates)


# --------------------------------------------------------------------------
# the port against the JAX package on the same fake backend
# --------------------------------------------------------------------------

@pytest.mark.parametrize("features", [False, True])
def test_recommendations_equal_the_jax_package(features):
    kwargs = {"item_features": make_features()} if features else {}
    ref = JaxLightFMWrapper(_known_user_data(JaxData), **kwargs)
    ref.verbose = False
    port = _port(LightFMWrapper, _known_user_data(), **kwargs)
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)


@pytest.mark.parametrize("test_sample", [None, 12])
def test_cold_start_recommendations_equal_the_jax_package(test_sample):
    ref = JaxLightFMItemColdStart(_cold_data(JaxColdData, test_sample),
                                  item_features=make_features())
    ref.verbose = False
    port = _port(LightFMItemColdStart, _cold_data(test_sample=test_sample),
                 item_features=make_features())
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)


def test_construction_without_lightfm_raises(known_user_data, monkeypatch):
    monkeypatch.setitem(sys.modules, "lightfm", None)
    with pytest.raises(ImportError, match="lightfm"):
        LightFMWrapper(known_user_data, device="cpu")
