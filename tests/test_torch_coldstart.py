"""The item cold-start scenario: the port's data model and models
(``data/coldstart.py``, ``models/coldstart.py``) against ``polara_tpu``'s
on the CPU.  The same seeded frames go through both packages; the split,
the flags, the recode and the sampled representative users must be
identical frames, and the models' recommendations identical ids (factor
models from the JAX package's f64 factors carried across, their score
blocks within 1e-8 of the row scale: the port recomputes the
pseudo-inverse Grams).  Each tolerance is stated with its test."""
import numpy as np
import pandas as pd
import pytest
import torch

import polara_tpu.data as jdata
import polara_tpu.models as jmodels
from polara_tpu import config as jconfig
import polara_tpu_torch.data as tdata
import polara_tpu_torch.models as tmodels
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.runtime.convert import factors_from_jax

N_USERS, N_ITEMS = 60, 36
GENRES = ["action", "comedy", "drama", "horror", "scifi"]


def _events(seed=0):
    rs = np.random.RandomState(seed)
    rows = []
    for user in range(N_USERS):
        for item in rs.choice(N_ITEMS, size=rs.randint(5, 14),
                              replace=False):
            rows.append((user, item, rs.randint(1, 6)))
    return pd.DataFrame(rows, columns=["userid", "movieid", "rating"])


def _features(seed=0):
    """Genres and tags per item; the last four items carry only labels no
    other item has, so a cold one among them fails the overlap check."""
    rs = np.random.RandomState(seed)
    genres = [sorted(rs.choice(GENRES, rs.randint(1, 3),
                               replace=False).tolist())
              for _ in range(N_ITEMS)]
    tags = [[f"t{t}" for t in rs.randint(0, 6, rs.randint(0, 3))]
            for _ in range(N_ITEMS)]
    for item in range(N_ITEMS - 4, N_ITEMS):
        genres[item], tags[item] = [f"only{item}"], []
    return pd.DataFrame({"genres": genres, "tags": tags},
                        index=pd.RangeIndex(N_ITEMS))


def _similarity(seed=3):
    """A dyadic similarity (multiples of 1/8): every SIM(cs) score is
    exact."""
    rs = np.random.RandomState(seed)
    base = rs.rand(N_ITEMS, 4)
    sim = base @ base.T
    d = np.sqrt(np.diag(sim))
    return np.round(sim / d[:, None] / d[None, :] * 8) / 8


def _pair(test_sample=None, fold=None):
    """Both packages' ``ItemColdStartSimilarityData`` on one scenario; the
    cold index is also recorded just before the clean-up drops its
    ``is_valid``/``is_repr`` flags."""
    out = []
    for package in (jdata, tdata):
        class Recorded(package.ItemColdStartSimilarityData):
            def _cleanup_cold_items(self):
                self.__dict__.setdefault("flagged", []).append(
                    self.index.itemid.cold_start.copy())
                super()._cleanup_cold_items()

        data = Recorded(_events(), "userid", "movieid", "rating",
                        item_features=_features(), seed=0, verbose=False,
                        relations_matrices={"movieid": _similarity()},
                        relations_indices={"movieid": np.arange(N_ITEMS)})
        if test_sample is not None:
            data.test_sample = test_sample
        if fold is not None:
            data.test_fold = fold
        data.prepare()
        out.append(data)
    return out


def _assert_same_split(jd, td):
    pd.testing.assert_frame_equal(td.test.holdout, jd.test.holdout)
    assert td.test.testset is None and jd.test.testset is None
    pd.testing.assert_frame_equal(td.training, jd.training)
    for name in ("training", "cold_start"):
        pd.testing.assert_frame_equal(getattr(td.index.itemid, name),
                                      getattr(jd.index.itemid, name))
    pd.testing.assert_frame_equal(td.index.userid.training,
                                  jd.index.userid.training)
    assert len(td.flagged) == len(jd.flagged)
    for got, want in zip(td.flagged, jd.flagged):
        pd.testing.assert_frame_equal(got, want)
    if jd.representative_users is None:
        assert td.representative_users is None
    else:
        pd.testing.assert_frame_equal(td.representative_users,
                                      jd.representative_users)
    assert td.get_test_shape() == jd.get_test_shape()


@pytest.mark.parametrize("test_sample,fold", [(None, None), (6, None),
                                              (12, None), (0.5, 2)])
def test_split_flags_and_recode_match_jax(test_sample, fold):
    """Cold-item fold split, holdout (all cold events, renamed column,
    sorted by the recoded ids), both indices, the representative users
    and the flags before clean-up: identical frames."""
    jd, td = _pair(test_sample, fold)
    _assert_same_split(jd, td)
    cold = td.index.itemid.cold_start
    assert cold["new"].tolist() == list(range(len(cold)))
    if test_sample is None and fold is None:
        assert "is_valid" in td.flagged[-1]     # the overlap check fired
        assert not td.flagged[-1]["is_valid"].all()
    if test_sample == 6:                        # a cold item no pool
        assert not td.flagged[-1]["is_repr"].all()  # user rated


def test_test_sample_change_refilters_like_jax():
    """Changing ``test_sample`` after ``prepare()`` re-runs the
    post-processing (a test-only update) in both packages: identical
    frames again, and models stay ready."""
    jd, td = _pair()
    model = tmodels.PopularityModelItemColdStart(td, device="cpu")
    model.build()
    for sample in (10, 0.4, None):
        for data in (jd, td):
            data.test_sample = sample
            data.update()
        _assert_same_split(jd, td)
    assert model._is_ready


def test_cold_similarity_slices_match_jax():
    jd, td = _pair(test_sample=12)
    got = td.cold_items_similarity
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jd.cold_items_similarity))
    assert got.shape == td.get_test_shape()[:1] + (
        td.index.itemid.training.shape[0],)
    assert td.cold_users_similarity is None


@pytest.fixture
def f64():
    saved = (jconfig.get_default("compute_dtype"),
             tconfig.get_default("compute_dtype"))
    jconfig.set_default("compute_dtype", "float64")
    tconfig.set_default("compute_dtype", "float64")
    yield
    jconfig.set_default("compute_dtype", saved[0])
    tconfig.set_default("compute_dtype", saved[1])


def _jax_factors(model):
    return {k: None if v is None else np.array(v)
            for k, v in model.factors.items()}


def _models(name, jd, td, **attrs):
    """The JAX model built; the port's one carrying its factors (factor
    models) or built itself (the rest)."""
    kw = {}
    if name.startswith("Random"):
        kw["seed"] = 5
    if name.startswith("LCE"):
        kw["item_features"] = _features()
    ref = getattr(jmodels, name)(jd, **kw)
    port = getattr(tmodels, name)(td, device="cpu", **kw)
    for model in (ref, port):
        model.verbose = False
        for key, value in attrs.items():
            setattr(model, key, value)
    ref.build()
    if hasattr(ref, "factors"):
        port.set_factors(factors_from_jax(_jax_factors(ref), device="cpu",
                                          dtype=torch.float64))
    else:
        port.build()
    return ref, port


MODELS = ["RandomModelItemColdStart", "PopularityModelItemColdStart",
          "SimilarityAggregationItemColdStart", "SVDModelItemColdStart",
          "ScaledSVDItemColdStart", "HybridSVDItemColdStart",
          "ScaledHybridSVDItemColdStart", "LCEModelItemColdStart"]


@pytest.mark.parametrize("test_sample", [None, 12])
@pytest.mark.parametrize("name", MODELS)
def test_cold_start_models_match_jax(f64, name, test_sample):
    """Each model's recommendations (cold items x top-10 users, internal
    user ids, PAD where the pool is short) equal the JAX model's; factor
    models score from its f64 factors carried across (the port rebuilds
    the feature labels and the pseudo-inverse Grams in ``set_factors``),
    with score blocks within 1e-8 of the row scale; metrics within
    1e-12."""
    jd, td = _pair(test_sample)
    ref, port = _models(name, jd, td, rank=6)
    assert port.method == ref.method
    want = np.asarray(ref.recommendations)
    got = port.recommendations
    n_cold = td.index.itemid.cold_start.shape[0]
    assert got.shape == (n_cold, 10)
    np.testing.assert_array_equal(got, want)
    if hasattr(ref, "compute_cold_scores"):
        candidates = port._candidate_users()
        s_want = np.asarray(ref.compute_cold_scores(candidates))
        s_got = port.compute_cold_scores(candidates).numpy()
        scale = np.abs(s_want).max(axis=1, keepdims=True)
        assert (np.abs(s_got - s_want) <= 1e-8 * scale).all()
    if getattr(ref, "item_features_labels", None) is not None:
        assert port.item_features_labels == ref.item_features_labels
    for g, w in zip(port.evaluate(["relevance", "ranking"]),
                    ref.evaluate(["relevance", "ranking"])):
        for key, wv in w._asdict().items():
            if wv is not None:
                np.testing.assert_allclose(getattr(g, key), wv, rtol=0,
                                           atol=1e-12, err_msg=key)


def test_small_pool_pads_and_self_built_models_run():
    """Four representative users for top-10: PAD (-1) fills the rows in
    both packages; the port's own builds (f32) give recommendations of
    the contract's shape over the pool."""
    jd, td = _pair(test_sample=4)
    pool = set(td.representative_users["new"])
    for name in MODELS:
        kw = {"item_features": _features()} if name.startswith("LCE") else {}
        port = getattr(tmodels, name)(td, device="cpu", **kw)
        port.verbose = False
        if hasattr(port, "rank"):
            port.rank = 3
        recs = port.recommendations
        assert recs.shape == (td.index.itemid.cold_start.shape[0], 10)
        assert set(np.unique(recs[:, :4])) <= pool
        assert (recs[:, 4:] == -1).all()


def test_pinv_cut_with_rank_above_the_labels(f64):
    """PureSVD(cs) at rank 12 over the 5 genre labels only: the 12 x 12
    feature Gram has rank 5, so which near-zero singular values survive
    the pseudo-inverse decides the scores.  With the JAX package's cut
    (10·max(m, n)·eps·s₀) the port's scores equal the JAX package's
    within 1e-8 of the row scale, and so do the ids."""
    jd, td = _pair()
    genres = _features()[["genres"]]
    for data in (jd, td):
        data.item_features = genres
    ref, port = _models("SVDModelItemColdStart", jd, td, rank=12)
    mapping = port.item_features_embeddings
    gram = mapping.T @ mapping
    assert gram.shape == (12, 12)
    assert int(torch.linalg.matrix_rank(gram)) < 12
    s_want = np.asarray(ref.compute_cold_scores(None))
    s_got = port.compute_cold_scores(None).numpy()
    scale = np.abs(s_want).max(axis=1, keepdims=True)
    assert (np.abs(s_got - s_want) <= 1e-8 * scale).all()
    np.testing.assert_array_equal(port.recommendations,
                                  np.asarray(ref.recommendations))


def test_rank_sweep_resyncs_the_feature_transform(f64):
    """Lowering the rank truncates the factors and the feature mapping, and
    the inverse Gram follows it down (the JAX package's ids at each
    rank); factors installed wider than the rank resync it too."""
    jd, td = _pair()
    ref, port = _models("SVDModelItemColdStart", jd, td, rank=8)
    full = {k: v.clone() for k, v in port.factors.items()}
    picks = {}
    for rank in (6, 4):
        for model in (ref, port):
            model.rank = rank
            model._recommendations = None
        assert port._transform_invgram.shape == (rank, rank)
        picks[rank] = port.recommendations
        np.testing.assert_array_equal(picks[rank],
                                      np.asarray(ref.recommendations))
    port.set_factors(full)
    assert port._transform_invgram.shape == (8, 8)
    port.rank = 6
    assert port._transform_invgram.shape == (6, 6)
    np.testing.assert_array_equal(port.recommendations, picks[6])


def _jaxpr_shapes(jaxpr):
    for eqn in jaxpr.eqns:
        for var in eqn.outvars:
            yield tuple(var.aval.shape)
        for param in eqn.params.values():
            inner = getattr(param, "jaxpr", None)
            if inner is not None:
                yield from _jaxpr_shapes(getattr(inner, "jaxpr", inner))


def test_map_over_a_long_holdout_is_linear_in_its_length():
    """The cold-start holdout holds every event of a cold item (h ~ 3e4 at
    ML-10M geometry).  The JAX package's MAP@k forms a (rows, h, h)
    comparison (ROADMAP C3: 2.7 TB at that size); the port sums the
    precision over the k recommendation slots instead.  On a short
    holdout both give the same MAP (1e-12); on a 30,000-event row the
    port's equals the direct per-row average precision.  A row whose
    holdout repeats items (a duplicate (user, item) event in a cold
    item's holdout of users) counts each repeat, as the JAX package
    does."""
    import jax
    import jax.numpy as jnp
    from polara_tpu.evaluation.metrics import _metrics_core
    from polara_tpu_torch.evaluation.metrics import metrics_core
    h, k = 300, 10
    rs = np.random.RandomState(0)
    items = np.stack([rs.permutation(5000)[:h] for _ in range(4)])
    recs = np.where(rs.rand(4, k) < 0.5, items[:, :k],
                    rs.randint(5000, 6000, (4, k)))
    # row 3 repeats three recommended items in its holdout (once, twice
    # and once more), and recommends one item that is missing from it
    recs[3] = items[3, :k]
    items[3, [20, 21, 22, 40]] = recs[3, [1, 1, 4, 8]]
    items[3, 6] = 5999
    valid = np.ones((4, h), bool)
    valid[2, 5:] = False                   # a short row
    fb = rs.randint(1, 6, (4, h)).astype(np.float64)
    args = (recs, items, fb, valid, valid)
    kw = dict(topk=k, switch_positive=0.0, alternative=True,
              has_split=False, penalty=0.0)
    shapes = set(_jaxpr_shapes(jax.make_jaxpr(
        lambda *a: _metrics_core(*a, **kw))(*map(jnp.asarray, args)).jaxpr))
    assert (4, h, h) in shapes
    want = float(_metrics_core(*map(jnp.asarray, args), **kw)["map"])
    got = metrics_core(*map(torch.as_tensor, args), **kw)
    assert abs(float(got["map"]) - want) <= 1e-12
    # the repeated row alone, against JAX and against its count by hand:
    # slots 1..10 hold 1, 3, 1, 1, 2, 1, 0, 1, 2, 1 holdout entries
    row = tuple(a[3:] for a in args)
    want = float(_metrics_core(*map(jnp.asarray, row), **kw)["map"])
    got = float(metrics_core(*map(torch.as_tensor, row), **kw)["map"])
    m = np.array([1, 3, 1, 1, 2, 1, 0, 1, 2, 1])
    by_hand = (m * np.cumsum(m) / np.arange(1, k + 1)).sum() / k
    assert abs(got - want) <= 1e-12 and abs(got - by_hand) <= 1e-12

    h = 30_000
    items = rs.permutation(40_000)[:h][None]
    recs = np.array([[items[0, 7], 39_999, items[0, 0], -1, items[0, 99],
                      40_001, 40_002, items[0, 5], 40_003, 40_004]])
    valid = np.ones((1, h), bool)
    got = metrics_core(torch.as_tensor(recs), torch.as_tensor(items),
                       torch.ones((1, h), dtype=torch.float64),
                       torch.as_tensor(valid), torch.as_tensor(valid), **kw)
    hits = np.isin(recs[0], items[0]) & (recs[0] >= 0)
    direct = (np.cumsum(hits) / np.arange(1, k + 1))[hits].sum() / k
    assert abs(float(got["map"]) - direct) <= 1e-15
