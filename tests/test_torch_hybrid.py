"""The side-information slice: the port's ``SimilarityDataModel`` and
hybrid models (``data/hybrid.py``, ``models/hybrid.py``) against
``polara_tpu``'s on the CPU.  The same seeded frames and matrices go
through both packages; builds compare in f64 (the solvers start from
different random draws, so factors compare by singular values and
principal angles), and factors carried across are dyadic, so every score
is exact in f32 and ids, ties included, must match bit for bit.  Each
tolerance is stated with its test."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import polara_tpu.data as jdata
import polara_tpu.models as jmodels
from polara_tpu import config as jconfig
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu.models import hybrid as jhybrid
from polara_tpu.runtime.serving import ServingBundle as JaxBundle
import polara_tpu_torch.data as tdata
import polara_tpu_torch.models as tmodels
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.datasets import compute_graph_laplacian
from polara_tpu_torch.models import hybrid as thybrid
from polara_tpu_torch.runtime import ServingBundle
from polara_tpu_torch.runtime.convert import factors_from_jax

N_USERS, N_ITEMS = 80, 40


@pytest.fixture(scope="module")
def events():
    return make_synthetic_interactions(n_users=N_USERS, n_items=N_ITEMS,
                                       n_events=1500, seed=0)


def _similarity(n, seed=0, dyadic=False):
    rs = np.random.RandomState(seed)
    base = rs.rand(n, 5)
    sim = base @ base.T
    sim = sim / np.sqrt(np.outer(np.diag(sim), np.diag(sim)))
    return np.round(sim * 8) / 8 if dyadic else sim


def _pair(events, matrix, data_cls=("SimilarityDataModel",), **config):
    """The same scenario in both packages: warm_start off, two held-out
    items per test user, ``matrix`` as the item relations."""
    ids = np.sort(events["movieid"].unique())
    out = []
    for package in (jdata, tdata):
        bases = tuple(getattr(package, name) for name in data_cls)
        cls = bases[0] if len(bases) == 1 else type("Data", bases, {})
        data = cls(events.copy(), "userid", "movieid", "rating",
                   relations_matrices={"movieid": matrix, "userid": None},
                   relations_indices={"movieid": ids, "userid": None},
                   seed=0, verbose=False)
        data.warm_start = False
        data.holdout_size = 2
        for name, value in config.items():
            setattr(data, name, value)
        data.update()
        out.append(data)
    return out


@pytest.fixture(scope="module")
def pair(events):
    return _pair(events, _similarity(N_ITEMS))


@pytest.fixture
def f64():
    """Both packages compute in f64 for the duration of a test."""
    saved = (jconfig.get_default("compute_dtype"),
             tconfig.get_default("compute_dtype"))
    jconfig.set_default("compute_dtype", "float64")
    tconfig.set_default("compute_dtype", "float64")
    yield
    jconfig.set_default("compute_dtype", saved[0])
    tconfig.set_default("compute_dtype", saved[1])


def _model(cls, data, **attrs):
    port = cls.__module__.startswith("polara_tpu_torch")
    model = cls(data, device="cpu") if port else cls(data)
    model.verbose = False
    for name, value in attrs.items():
        setattr(model, name, value)
    return model


def _same_metrics(got, want):
    """Metric tuples equal within 1e-12 (the metrics see identical ids;
    the bound covers f64 summation order)."""
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert [type(g).__name__ for g in got] == [type(w).__name__
                                               for w in want]
    for g, w in zip(got, want):
        for name, wv in w._asdict().items():
            gv = getattr(g, name)
            if wv is None:
                assert gv is None, name
            else:
                np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-12,
                                           err_msg=name)


def _max_sin(a, b) -> float:
    """Sine of the largest principal angle between two column spans (f64,
    from the projection residual)."""
    qa = np.linalg.qr(np.asarray(a, np.float64))[0]
    qb = np.linalg.qr(np.asarray(b, np.float64))[0]
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


# --- the data model ---------------------------------------------------------

def test_relations_reindexed_and_invalidated(events):
    """The reindexed relations (unit diagonal) equal the JAX package's
    exactly; a change of split drops them (and a model's device copy),
    and they come back equal to the JAX package's again."""
    jd, td = _pair(events, _similarity(N_ITEMS))
    np.testing.assert_array_equal(td.item_relations.numpy(),
                                  np.asarray(jd.item_relations))
    assert (np.diag(td.item_relations.numpy()) == 1).all()
    assert td.user_relations is None
    model = _model(tmodels.SimilarityAggregation, td)
    model.device_relations("movieid")
    for data in (jd, td):
        data.test_fold = 1
        data.update()
        assert data._relations["movieid"] is None
    assert model._device_relations == {}
    np.testing.assert_array_equal(td.item_relations.numpy(),
                                  np.asarray(jd.item_relations))


@pytest.mark.parametrize("kind", ["numpy", "scipy", "tensor"])
def test_relations_stay_on_their_device(events, kind):
    """numpy and scipy.sparse inputs become CPU tensors, a tensor keeps
    its device and its reindexed copy is taken there: all three give the
    JAX package's relations exactly."""
    sim = _similarity(N_ITEMS)
    matrix = {"numpy": sim, "scipy": sp.csr_matrix(sim),
              "tensor": torch.as_tensor(sim)}[kind]
    jd, td = _pair(events, sim)
    port = _pair(events, matrix)[1]
    assert port._rel_mat["movieid"].device == torch.device("cpu")
    if kind == "tensor":
        assert port._rel_mat["movieid"] is matrix
    np.testing.assert_array_equal(port.item_relations.numpy(),
                                  np.asarray(jd.item_relations))


def test_missing_relation_ids_raise(events):
    ids = np.sort(events["movieid"].unique())[1:]
    data = tdata.SimilarityDataModel(
        events.copy(), "userid", "movieid", "rating",
        relations_matrices={"movieid": _similarity(len(ids))},
        relations_indices={"movieid": ids}, seed=0, verbose=False)
    data.update()
    with pytest.raises(KeyError, match="missing from the relations index"):
        data.item_relations


# --- SimilarityAggregation ----------------------------------------------------

def test_similarity_aggregation_ids_exact(events):
    """A dyadic similarity (multiples of 1/8) makes every score exact:
    identical recommendations and metrics, explicit and implicit."""
    jd, td = _pair(events, _similarity(N_ITEMS, dyadic=True))
    for implicit in (False, True):
        ref = _model(jmodels.SimilarityAggregation, jd, implicit=implicit)
        port = _model(tmodels.SimilarityAggregation, td, implicit=implicit)
        np.testing.assert_array_equal(port.recommendations,
                                      ref.recommendations)
        _same_metrics(port.evaluate("relevance"), ref.evaluate("relevance"))
    assert not port.uses_fused_scoring(port.score_params())


# --- HybridSVD ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["HybridSVD", "ScaledHybridSVD"])
def test_hybrid_svd_build_matches_jax(pair, f64, name):
    """Built in f64 by each package (different random starts): singular
    values within 1e-8 relative, and the largest principal-angle sine of
    V and of both projectors below 1e-6."""
    jd, td = pair
    ref = _model(getattr(jmodels, name), jd, rank=6)
    ref.build()
    port = _model(getattr(tmodels, name), td, rank=6)
    port.build()
    assert port.method == ref.method
    s_ref = np.asarray(ref.factors["singular_values"])
    np.testing.assert_allclose(port.factors["singular_values"].numpy(),
                               s_ref, rtol=1e-8)
    for key in ("movieid", "movieid_projector_left",
                "movieid_projector_right"):
        assert _max_sin(port.factors[key].numpy(), ref.factors[key]) < 1e-6
    assert port.factors["movieid_projector_left"].dtype == torch.float64
    assert all(port.factors[key].is_contiguous() for key in
               ("movieid_projector_left", "movieid_projector_right"))


def _dyadic(shape, seed):
    rs = np.random.RandomState(seed)
    return np.clip(np.round(rs.randn(*shape) * 4) / 4, -2, 2)


def _carried_hybrid(jd, td, name="HybridSVD", rank=5):
    """A JAX hybrid model built, then both models on one dyadic factor
    set (``factors_from_jax``)."""
    ref = _model(getattr(jmodels, name), jd, rank=rank)
    ref.build()
    factors = {k: None if v is None else _dyadic(np.shape(v), seed)
               for seed, (k, v) in enumerate(sorted(ref.factors.items()))}
    ref.factors = {k: None if v is None else jnp.asarray(v, jnp.float32)
                   for k, v in factors.items()}
    port = _model(getattr(tmodels, name), td, rank=rank)
    port.set_factors(factors_from_jax(factors, device="cpu"))
    return ref, port


@pytest.mark.parametrize("fused", ["auto", True])
def test_hybrid_svd_carried_projectors_give_jax_ids(pair, fused):
    """Dyadic projectors carried across: identical ids through the unfused
    path and through the fused kernel's plain version (catalog order),
    and identical metrics."""
    jd, td = pair
    ref, port = _carried_hybrid(jd, td)
    saved = (tconfig.get_default("fused_scoring"),
             tconfig.get_default("fused_item_order"))
    try:
        tconfig.set_default("fused_scoring", fused)
        tconfig.set_default("fused_item_order", None)
        params = port.score_params()
        assert port.uses_fused_scoring(params) == (fused is True)
        assert params["item_panel"] is params["projector_left"]
        np.testing.assert_array_equal(port.recommendations,
                                      ref.recommendations)
        _same_metrics(port.evaluate(), ref.evaluate())
    finally:
        tconfig.set_default("fused_scoring", saved[0])
        tconfig.set_default("fused_item_order", saved[1])


def test_hybrid_svd_projection_is_reproducible(pair):
    """``proj_chunk`` over the right projector is the sorted segment sum
    of the SVD family: two calls give the same bits, equal to the dense
    product of the test profiles (dyadic factors: exact)."""
    jd, td = pair
    _, port = _carried_hybrid(jd, td)
    port.recommendations
    chunk = port._test_plan.chunks[0]
    params = port.score_params()
    first = tmodels.HybridSVD.proj_chunk(params, chunk)
    assert torch.equal(first, tmodels.HybridSVD.proj_chunk(params, chunk))
    profiles, _ = port.get_test_matrix()
    n = profiles.shape[0]
    torch.testing.assert_close(first[:n],
                               profiles @ params["projector_right"],
                               rtol=0, atol=0)


def test_rank_truncation_and_features_weight(pair, f64):
    """Lowering the rank truncates both projectors (the model stays
    ready); a new ``features_weight`` refactorizes in place to the JAX
    package's factor (1e-10) and renews the model, whose rebuild gives
    the JAX rebuild's singular values (1e-8 relative)."""
    jd, td = pair
    port = _model(tmodels.HybridSVD, td, rank=8)
    port.build()
    vl, vr = (v.clone() for v in port.get_item_projector())
    port.rank = 4
    left, right = port.get_item_projector()
    assert port._is_ready
    assert torch.equal(left, vl[:, :4]) and torch.equal(right, vr[:, :4])

    ref = _model(jmodels.HybridSVD, jd, rank=4)
    ref.build()
    for model in (ref, port):
        model.features_weight = 0.8
        assert not model._is_ready
    np.testing.assert_allclose(port.item_cholesky_factor.L.numpy(),
                               np.asarray(ref.item_cholesky_factor.L),
                               rtol=0, atol=1e-10)
    ref.build()
    port.build()
    np.testing.assert_allclose(port.factors["singular_values"].numpy(),
                               np.asarray(ref.factors["singular_values"]),
                               rtol=1e-8)


def test_identity_similarity_gives_pure_svd(events, f64):
    """With S = I, L = √2 I: HybridSVD's scores are PureSVD's (projectors
    V/√2 and √2 V), so its recommendations equal PureSVD's from one seed
    and one solver setting."""
    _, td = _pair(events, np.eye(N_ITEMS))
    hybrid = _model(tmodels.HybridSVD, td, rank=6)
    pure = _model(tmodels.SVDModel, td, rank=6)
    np.testing.assert_array_equal(hybrid.recommendations,
                                  pure.recommendations)
    np.testing.assert_allclose(hybrid.factors["singular_values"].numpy(),
                               np.sqrt(2) * pure.factors["singular_values"]
                               .numpy(), rtol=1e-10)


def test_serving_bundle_from_hybrid_svd_serves_jax_ids(pair):
    """``ServingBundle.from_model`` on a HybridSVD serves through the right
    projector and ranks against the left one: the same dyadic factors
    give the JAX bundle's ids on id lists, rating dicts and profiles."""
    jd, td = pair
    ref, port = _carried_hybrid(jd, td)
    jb = JaxBundle.from_model(ref, batch_size=8)
    tb = ServingBundle.from_model(port, batch_size=8)
    assert tb.left_panel is not tb.item_factors
    assert tb.left_panel.is_contiguous()      # the kernel's panel layout
    port.factors["movieid_projector_left"] = \
        port.factors["movieid_projector_left"].T.contiguous().T
    assert ServingBundle.from_model(port).left_panel.is_contiguous()
    torch.testing.assert_close(tb.left_panel,
                               port.factors["movieid_projector_left"].float())
    rs = np.random.RandomState(3)
    lists = [rs.choice(N_ITEMS, rs.randint(1, 12), replace=False).tolist()
             for _ in range(19)]
    dicts = [{i: int(rs.randint(1, 6)) for i in e} for e in lists]
    for requests in (lists, dicts):
        np.testing.assert_array_equal(tb.recommend_events(requests),
                                      jb.recommend_events(requests))
    profiles = np.zeros((len(dicts), N_ITEMS))
    for row, d in enumerate(dicts):
        profiles[row, list(d)] = list(d.values())
    np.testing.assert_array_equal(tb.recommend(profiles),
                                  jb.recommend(profiles))


# --- KPMF ---------------------------------------------------------------------

def _laplacian_pair(events, **config):
    """Both packages' side-relations data without the unit-diagonal mixin,
    carrying an item Laplacian of a 3-nearest-neighbour genre graph."""
    import pandas as pd
    ids = np.sort(events["movieid"].unique())
    rs = np.random.RandomState(7)
    genres = (rs.rand(len(ids), 5) < 0.4).astype(float)
    adjacency = thybrid.knn_graph(torch.as_tensor(genres), 3).numpy()
    edges = [(ids[a], ids[b]) for a, b in zip(*np.nonzero(adjacency))]
    laplacian, _ = compute_graph_laplacian(edges, pd.Index(ids))
    return _pair(events, laplacian,
                 data_cls=("SideRelationsMixin", "RecommenderData"),
                 **config)


@pytest.mark.parametrize("kernel_type,atol", [("reg", 0.0), ("dif", 1e-10)])
def test_kpmf_kernels_match_jax(events, f64, kernel_type, atol):
    """Item kernels from the Laplacian: ``reg`` (I + γL) exact, ``dif``
    (``matrix_exp`` against ``jax.scipy.linalg.expm``, two Padé
    approximations) within 1e-10 (f64; β raised to 0.5 so the
    exponential is far from I); the user kernel without relations is
    σ²I."""
    jd, td = _laplacian_pair(events)
    ref = jmodels.KernelizedPMF(jd, seed=0)
    port = tmodels.KernelizedPMF(td, seed=0, device="cpu")
    for model in (ref, port):
        model.kernel_type = kernel_type
        model.beta = 0.5
        model.factor_sigma["userid"] = 1.5
    got = port.item_kernel_matrix.numpy()
    want = np.asarray(ref.item_kernel_matrix)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.abs(got - np.eye(len(got))).max() > 0.05
    np.testing.assert_array_equal(port.user_kernel_matrix.numpy(),
                                  np.asarray(ref.user_kernel_matrix))
    assert (np.diag(port.user_kernel_matrix.numpy()) == 2.25).all()


def test_kpmf_three_epochs_from_the_jax_start(events, f64):
    """KPMF from the JAX package's own start (its ``jax.random`` draw of
    P and Q), one batch per epoch (the epoch's permutation then only
    reorders the batch's sums): after 3 epochs the factors within 1e-9
    relative and the RMSE history within 1e-10 relative of the JAX
    package's (f64)."""
    jd, td = _laplacian_pair(events)
    kw = dict(rank=4, num_epochs=3, batch_size=4096, learn_rate=0.05,
              tolerance=0.0)
    ref = jmodels.KernelizedPMF(jd, seed=3)
    port = tmodels.KernelizedPMF(td, seed=3, device="cpu")
    for model in (ref, port):
        model.verbose = False
        for name, value in kw.items():
            setattr(model, name, value)
    ref.build()
    key = jax.random.key(3)
    kp, kq, _ = jax.random.split(key, 3)
    n_users = td.index.userid.training.shape[0]
    start = (np.array(0.1 * jax.random.normal(kp, (n_users, 4),
                                              jnp.float64)),
             np.array(0.1 * jax.random.normal(kq, (N_ITEMS, 4),
                                              jnp.float64)))
    port.build(init=start)
    assert len(port.rmse_history) == 3
    np.testing.assert_allclose(port.rmse_history, ref.rmse_history,
                               rtol=1e-10)
    for name in ("userid", "movieid"):
        want = np.asarray(ref.factors[name])
        np.testing.assert_allclose(port.factors[name].numpy(), want,
                                   rtol=0, atol=1e-9 * np.abs(want).max())


def test_kpmf_carried_factors_give_jax_ids(events):
    """A built JAX KPMF's user and item factors, made dyadic and carried
    across: identical recommendations for the known test users without a
    build (the factor lookup of PMF)."""
    jd, td = _laplacian_pair(events)
    ref = jmodels.KernelizedPMF(jd, seed=0)
    ref.verbose = False
    ref.num_epochs = 2
    ref.build()
    factors = {k: _dyadic(np.shape(v), seed)
               for seed, (k, v) in enumerate(sorted(ref.factors.items()))}
    ref.factors = {k: jnp.asarray(v, jnp.float32) for k, v in
                   factors.items()}
    port = tmodels.KernelizedPMF(td, seed=0, device="cpu")
    port.verbose = False
    port.set_factors(factors_from_jax(factors, device="cpu"))
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)


# --- LCE ----------------------------------------------------------------------

@pytest.mark.parametrize("binary", [True, False])
def test_knn_graph_bit_identical_with_ties(binary):
    """Binary features with duplicate rows (massive distance ties): the
    port's stable ranking picks the JAX package's neighbours, bit for
    bit, with and without binary weights."""
    rs = np.random.RandomState(0)
    rows = (rs.rand(8, 6) < 0.5).astype(np.float32)
    features = rows[rs.randint(0, 8, 30)]          # duplicates
    want = np.asarray(jhybrid.knn_graph(jnp.asarray(features), 5, binary))
    got = thybrid.knn_graph(torch.as_tensor(features), 5, binary).numpy()
    np.testing.assert_array_equal(got, want)
    if binary:                                     # self + 5 neighbours
        assert ((got != 0).sum(axis=1) == 6).all()


def test_lce_objective_history_from_the_jax_start(capsys):
    """LCE from the JAX package's own uniform start: the objective after
    every update within 1e-8 relative (the JAX side's read from its
    verbose lines) and the factors within 1e-8 of their scale (f64)."""
    rs = np.random.RandomState(1)
    xs = (rs.rand(15, 6) < 0.4).astype(float)
    xu = rs.rand(15, 12) * (rs.rand(15, 12) < 0.5)
    adjacency = np.array(jhybrid.knn_graph(jnp.asarray(xs), 3))
    kw = dict(k=4, maxiter=10, epsilon=0.0)
    want = jhybrid.local_collective_embeddings(
        jnp.asarray(xs), jnp.asarray(xu), jnp.asarray(adjacency), seed=0,
        verbose=True, **kw)
    printed = [float(x) for x in re.findall(r"Objective: (\S+)",
                                            capsys.readouterr().out)]
    kw_, ks, ku = jax.random.split(jax.random.key(0), 3)
    start = (jax.random.uniform(kw_, (15, 4), jnp.float64),
             jax.random.uniform(ks, (4, 6), jnp.float64),
             jax.random.uniform(ku, (4, 12), jnp.float64))
    history = []
    got = thybrid.local_collective_embeddings(
        torch.as_tensor(xs), torch.as_tensor(xu), torch.as_tensor(adjacency),
        init=[np.array(x) for x in start], history=history, **kw)
    assert len(history) == 11 and len(printed) == 10
    np.testing.assert_allclose(history[1:], printed, rtol=1e-8)
    assert all(b <= a for a, b in zip(history, history[1:]))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-8 * np.abs(w).max())


def _item_features(data):
    import pandas as pd
    rs = np.random.RandomState(0)
    ids = data.index.itemid["old"].values
    return pd.DataFrame({"genre": [[int(g) for g in rs.choice(6, 2)]
                                   for _ in ids]}, index=ids)


def test_lce_model_from_carried_factors(pair):
    """A built JAX LCE model's factors, made dyadic and carried across:
    identical recommendations (through the unfused path, and the fused
    kernel's plain version) and metrics; warm start raises in both."""
    jd, td = pair
    features = _item_features(jd)
    ref = jmodels.LCEModel(jd, item_features=features)
    ref.verbose = False
    ref.rank, ref.max_iterations = 4, 3
    ref.build()
    factors = {k: _dyadic(np.shape(v), seed)
               for seed, (k, v) in enumerate(sorted(ref.factors.items()))}
    ref.factors = {k: jnp.asarray(v, jnp.float32) for k, v in
                   factors.items()}
    port = tmodels.LCEModel(td, item_features=features, device="cpu")
    port.verbose = False
    port.rank = 4
    port.set_factors(factors_from_jax(factors, device="cpu"))
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)
    _same_metrics(port.evaluate(), ref.evaluate())
    assert port._fused_scoring_capable()
    saved = tconfig.get_default("fused_scoring")
    try:
        tconfig.set_default("fused_scoring", True)
        port._recommendations = None
        fused = port.recommendations
    finally:
        tconfig.set_default("fused_scoring", saved)
    assert (fused != -1).all()
    np.testing.assert_array_equal(np.sort(fused, 1),
                                  np.sort(ref.recommendations, 1))


def test_lce_model_builds_and_descends(pair):
    """The port's own LCE build through the data model: the objective
    never rises, the factors are non-negative, the metrics finite."""
    _, td = pair
    port = tmodels.LCEModel(td, item_features=_item_features(td),
                            device="cpu")
    port.verbose = False
    port.rank, port.max_iterations, port.seed = 4, 5, 0
    scores = port.evaluate("relevance")
    history = port.objective_history
    assert len(history) >= 2
    assert all(b <= a * (1 + 1e-6) for a, b in zip(history, history[1:]))
    assert all((f >= 0).all() for f in port.factors.values())
    assert np.isfinite(scores.recall)
