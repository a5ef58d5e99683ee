"""The rest of the port's ``RecommenderModel`` surface against
``polara_tpu``'s: single-user recommendations, the test matrix, the
checkpoint format (saved by either package, loaded by the other) and the
reference-style metric accessors."""
import numpy as np
import pytest

from polara_tpu.evaluation import metrics as jmetrics
from polara_tpu.models import CooccurrenceModel as JaxCooc
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu_torch.evaluation import metrics as tmetrics
from polara_tpu_torch.models import CooccurrenceModel as TorchCooc
from polara_tpu_torch.models import SVDModel as TorchSVD
from polara_tpu_torch.runtime.convert import factors_from_jax

from test_torch_svd_model import _jax_factors, _pair

RANK = 5


def _cooc_pair(frame, **config):
    jdata, tdata = _pair(frame, **config)
    ref, port = JaxCooc(jdata), TorchCooc(tdata, device="cpu")
    ref.verbose = port.verbose = False
    return ref, port


@pytest.mark.parametrize("config", [dict(), dict(warm_start=False,
                                                 holdout_size=1)])
def test_show_recommendations_by_user(synthetic_interactions, config):
    """Integer co-occurrence scores: the same top items and seen items for
    test users given by id."""
    ref, port = _cooc_pair(synthetic_interactions, **config)
    users = (range(3) if not config else
             port.data.test.holdout["userid"].unique()[:3])
    for user in users:
        got = port.show_recommendations(int(user), topk=7)
        want = ref.show_recommendations(int(user), topk=7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_show_recommendations_by_items(synthetic_interactions):
    ref, port = _cooc_pair(synthetic_interactions)
    for info in ([3, 11, 17], {2: 5, 9: 1, 30: 4}):
        got = port.show_recommendations(info)
        want = ref.show_recommendations(info)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert port.data.test.holdout is not None    # the test data is back


@pytest.mark.parametrize("user_slice", [None, (2, 9)])
def test_get_test_matrix(synthetic_interactions, user_slice):
    ref, port = _cooc_pair(synthetic_interactions)
    got, got_users = port.get_test_matrix(user_slice)
    want, want_users = ref.get_test_matrix(user_slice)
    assert got.device.type == "cpu" and got.dtype == port.compute_dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_users, want_users)
    assert port.get_base_configuration() == ref.get_base_configuration()


def _svd(cls, data, **kwargs):
    model = cls(data, **kwargs)
    model.verbose = False
    model.rank = RANK
    return model


def test_checkpoint_cross_loads(synthetic_interactions, tmp_path):
    """A JAX-saved npz loads into a port model, and a port-saved one into
    a JAX model: recommendations identical to the saving side's, metadata
    kept."""
    jdata, tdata = _pair(synthetic_interactions)
    ref = _svd(JaxSVD, jdata)
    ref.build()
    jax_path = str(tmp_path / "jax.npz")
    ref.save(jax_path)
    port = _svd(TorchSVD, tdata, device="cpu")
    meta = port.load(jax_path)
    assert meta == {"method": "PureSVD", "class": "SVDModel", "rank": RANK}
    assert port.factors["userid"] is None
    assert port.factors["movieid"].device.type == "cpu"
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)

    source = _svd(TorchSVD, tdata, device="cpu")
    source.set_factors(factors_from_jax(_jax_factors(ref), device="cpu"))
    port_path = str(tmp_path / "port.npz")
    source.save(port_path)
    back = _svd(JaxSVD, jdata)
    assert back.load(port_path) == meta
    np.testing.assert_array_equal(back.recommendations,
                                  source.recommendations)
    with np.load(port_path) as saved, np.load(jax_path) as original:
        assert sorted(saved.files) == sorted(original.files)
        for key in original.files:
            np.testing.assert_array_equal(saved[key], original[key])


ACCESSORS = ["get_hr_score", "get_rr_scores", "get_arhr_score",
             "get_mrr_score", "get_map_score", "get_ndcg_score",
             "get_ndcl_score", "get_ranking_scores", "get_relevance_scores",
             "get_hits"]


@pytest.mark.parametrize("name", ACCESSORS)
def test_metric_accessors_match_jax(synthetic_interactions, name):
    """Every ``get_*`` accessor on the same recommendations and holdout
    (with the positivity split, so nDCL and the negative counts are
    defined) equals the JAX package's to 1e-9; the series conversion and
    coverage too."""
    ref, port = _cooc_pair(synthetic_interactions)
    recs = port.recommendations
    holdout = port.data.test.holdout
    kwargs = dict(feedback="rating",
                  is_positive=(holdout["rating"] >= 4).values,
                  switch_positive=4, not_rated_penalty=0)
    got = getattr(tmetrics, name)(recs, holdout, "userid", "movieid",
                                  **kwargs)
    want = getattr(jmetrics, name)(recs, holdout, "userid", "movieid",
                                   **kwargs)
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), rtol=0,
                               atol=1e-9, equal_nan=True)
    if hasattr(want, "_asdict"):
        assert type(got).__name__ == type(want).__name__
        series = tmetrics.convert_scores_to_series([got])
        np.testing.assert_allclose(
            series.values.astype(float),
            jmetrics.convert_scores_to_series([want]).values.astype(float),
            rtol=0, atol=1e-9, equal_nan=True)
    assert (tmetrics.get_experience_scores(recs, 40)
            == jmetrics.get_experience_scores(recs, 40))
