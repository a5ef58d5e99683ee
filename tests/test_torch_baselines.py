"""Baselines of the port against ``polara_tpu``'s on the ``conftest.py``
fixture.  Popularity, co-occurrence and top-score are integer scores, exact
in f32 on both sides, so recommendations must be identical, ties
included; random scores come from different streams and are held to
shape, range and reproducibility."""
import warnings

import numpy as np
import pytest

from polara_tpu.models import baselines as jb
from polara_tpu_torch.models import baselines as tb

from test_torch_svd_model import _pair

SCENARIOS = [dict(), dict(warm_start=False, holdout_size=1)]


def _model(cls, data, *args, port=False, **kwargs):
    if port:
        kwargs["device"] = "cpu"
    model = cls(*args, data, **kwargs) if args else cls(data, **kwargs)
    model.verbose = False
    return model


@pytest.mark.parametrize("config", SCENARIOS)
@pytest.mark.parametrize("name", ["PopularityModel", "CooccurrenceModel"])
def test_recommendations_identical(synthetic_interactions, config, name):
    jdata, tdata = _pair(synthetic_interactions, **config)
    ref = _model(getattr(jb, name), jdata)
    port = _model(getattr(tb, name), tdata, port=True)
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)
    for got, want in zip(port.evaluate(), ref.evaluate()):
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("variant", ["by_feedback", "implicit"])
def test_options_identical(synthetic_interactions, variant):
    jdata, tdata = _pair(synthetic_interactions)
    if variant == "by_feedback":
        ref, port = (_model(jb.PopularityModel, jdata),
                     _model(tb.PopularityModel, tdata, port=True))
        ref.by_feedback_value = port.by_feedback_value = True
    else:
        ref, port = (_model(jb.CooccurrenceModel, jdata),
                     _model(tb.CooccurrenceModel, tdata, port=True))
        ref.implicit = port.implicit = True
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)


@pytest.mark.parametrize("kind", ["mostpopular", "topscore"])
def test_non_personalized_identical(synthetic_interactions, kind):
    jdata, tdata = _pair(synthetic_interactions)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = _model(jb.NonPersonalized, jdata, kind)
    with pytest.warns(DeprecationWarning):
        port = _model(tb.NonPersonalized, tdata, kind, port=True)
    assert port.method == kind
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)


def test_random_model(synthetic_interactions):
    """Same shape as the JAX model's; ids in the catalog, unseen items
    first, no repeats per user; the same seed repeats the draw, another
    seed changes it."""
    jdata, tdata = _pair(synthetic_interactions)
    ref = _model(jb.RandomModel, jdata, seed=3)
    runs = [_model(tb.RandomModel, tdata, port=True, seed=s).recommendations
            for s in (3, 3, 4)]
    n_items = tdata.get_entity_index("movieid").shape[0]
    assert runs[0].shape == ref.recommendations.shape
    np.testing.assert_array_equal(runs[0], runs[1])
    assert (runs[0] != runs[2]).any()
    assert ((runs[0] >= 0) & (runs[0] < n_items)).all()
    srt = np.sort(runs[0], axis=1)
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rnd = _model(tb.NonPersonalized, tdata, "random", port=True, seed=3)
    assert rnd.recommendations.shape == runs[0].shape
