"""The port's feature encoders and similarity functions
(``preprocessing/features.py``) and its dataset helpers
(``get_split_genres``, ``compute_graph_laplacian``) against
``polara_tpu``'s on the CPU: the same frames through both packages."""
import numpy as np
import pandas as pd
import pytest
import torch

from polara_tpu.datasets import compute_graph_laplacian as jax_laplacian
from polara_tpu.datasets import get_split_genres as jax_split_genres
from polara_tpu.preprocessing import features as jf
from polara_tpu_torch.datasets import compute_graph_laplacian
from polara_tpu_torch.datasets import get_split_genres
from polara_tpu_torch.preprocessing import features as tf

GENRES = ["Action", "Comedy", "Drama", "Horror", "Sci-Fi", "Romance"]


@pytest.fixture(scope="module")
def meta():
    """Two list-valued columns over 30 items: genres (1-3 labels, some
    repeated within a row) and tags (0-2 labels)."""
    rs = np.random.RandomState(0)
    genres = [list(rs.choice(GENRES, rs.randint(1, 4))) for _ in range(30)]
    tags = [[f"t{t}" for t in rs.randint(0, 8, rs.randint(0, 3))]
            for _ in range(30)]
    return pd.DataFrame({"genres": genres, "tags": tags},
                        index=pd.RangeIndex(100, 130))


def _same_sparse(got, want):
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_uniquify_ordered_and_indicator_matrix():
    seq = [3, 1, 3, 2, 1]
    assert tf.uniquify_ordered(seq) == jf.uniquify_ordered(seq) == [3, 1, 2]
    labels = pd.Series([[0, 2], [], [1], [2, 0, 1]])
    _same_sparse(tf.build_indicator_matrix(labels),
                 jf.build_indicator_matrix(labels))
    _same_sparse(tf.build_indicator_matrix(labels, 5),
                 jf.build_indicator_matrix(labels, 5))


@pytest.mark.parametrize("ranking", [None, True, "exponential",
                                     lambda n: 2.0 ** -n])
@pytest.mark.parametrize("deduplicate", [True, False])
def test_feature2sparse_matches_jax(meta, ranking, deduplicate):
    """Identical sparse structure, values and label index."""
    got, got_labels = tf.feature2sparse(meta["genres"], ranking=ranking,
                                        deduplicate=deduplicate)
    want, want_labels = jf.feature2sparse(meta["genres"], ranking=ranking,
                                          deduplicate=deduplicate)
    _same_sparse(got, want)
    assert got_labels == want_labels


def test_feature2sparse_with_known_labels_matches_jax(meta):
    """Labels given: unknown labels are dropped in both packages."""
    labels = {"Drama": 0, "Action": 1}
    got, got_labels = tf.feature2sparse(meta["genres"], labels=labels)
    want, want_labels = jf.feature2sparse(meta["genres"], labels=labels)
    _same_sparse(got, want)
    assert got_labels == want_labels


@pytest.mark.parametrize("kwargs", [
    dict(), dict(normalize=False), dict(add_identity=True),
    dict(stacked_index=True, add_identity=True), dict(ranking="linear"),
])
def test_stack_features_matches_jax(meta, kwargs):
    """The stacked (optionally identity-prefixed, row-normalized) blocks
    and their label indices are identical."""
    got, got_labels = tf.stack_features(meta, **kwargs)
    want, want_labels = jf.stack_features(meta, **kwargs)
    _same_sparse(got.tocsr(), want.tocsr())
    assert got_labels == want_labels
    mats, lbls = tf.get_features_data(meta)
    jmats, jlbls = jf.get_features_data(meta)
    assert list(lbls) == list(jlbls) and lbls == jlbls
    for name in mats:
        _same_sparse(mats[name], jmats[name])


@pytest.mark.parametrize("metric", ["common", "cosine"])
def test_one_hot_similarity_matches_jax(meta, metric):
    """Binary one-hot inputs: "common" (shared-label counts over their
    maximum) is exact; cosine within 1e-12 (f64, rsqrt rounding)."""
    got, got_labels = tf.one_hot_similarity(meta, metric=metric,
                                            device="cpu")
    want, want_labels = jf.one_hot_similarity(meta, metric=metric)
    assert got_labels == want_labels
    want = np.asarray(want)
    assert got.dtype == getattr(torch, str(want.dtype))
    if metric == "common":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind,atol", [("jaccard", 0.0),
                                       ("cosine", 1e-6),
                                       ("tfidf-cosine", 1e-6),
                                       ("jaccard-weighted", 1e-6)])
def test_similarity_data_matches_jax(meta, kind, atol):
    """Per-feature similarities: jaccard on binary inputs is exact (a
    quotient of integer counts); the f32 cosine family within 1e-6."""
    got = tf.get_similarity_data(meta, kind, device="cpu")
    want = jf.get_similarity_data(meta, kind)
    assert list(got) == list(want)
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=atol)


def test_combined_similarity_matches_jax(meta):
    """The weighted sum of jaccard similarities, clipped at 1 with a unit
    diagonal: exact (one f32 weighted sum of exact terms)."""
    got = tf.combine_similarity_data(meta, weights=[0.75, 0.5],
                                     device="cpu")
    want = np.asarray(jf.combine_similarity_data(meta, weights=[0.75, 0.5]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diag(want) == 1).all()


def test_split_genres_matches_jax():
    genres = pd.DataFrame({"movieid": [1, 2, 3],
                           "movienm": ["a", "b", "c"],
                           "genres": ["Action|Comedy", "Drama",
                                      "Comedy|Drama|Horror"]})
    pd.testing.assert_frame_equal(get_split_genres(genres),
                                  jax_split_genres(genres))


def test_graph_laplacian_matches_jax():
    """Edges outside the index and self links are skipped; isolated
    entities keep zero rows: identical Laplacian and adjacency."""
    index = pd.Index([10, 20, 30, 40, 50])
    edges = [(10, 20), (20, 10), (20, 30), (30, 30), (40, 99), (10, 30)]
    got = compute_graph_laplacian(edges, index)
    want = jax_laplacian(edges, index)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.toarray(), w.toarray())
    assert (got[0].toarray()[3] == 0).all()   # 40: no edge kept
