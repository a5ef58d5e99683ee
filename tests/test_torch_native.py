"""The port's native host library (``polara_tpu_torch.native``) against
``polara_tpu.native``: the same C++ entry points, built separately, give
identical outputs on the same numpy inputs; and ``prepare()`` above 100k
events takes the native holdout path and splits exactly as the JAX
package does."""
import numpy as np
import pandas as pd
import pytest

from polara_tpu import native as jnative
from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu_torch import native as tnative
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.data.dataset import native_top_positions


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert tnative.native_available(), tnative.build_error
    assert jnative.native_available()
    assert tnative.library_path(tnative._FLAG_SETS[0]).parent.name == \
        "_build"


def _events(seed=0, n=5000, n_rows=300, n_cols=400):
    rs = np.random.RandomState(seed)
    rows = np.sort(rs.randint(0, n_rows, n)).astype(np.int32)
    cols = rs.randint(0, n_cols, n).astype(np.int32)
    return rs, rows, cols


def test_build_indptr():
    _, rows, _ = _events()
    np.testing.assert_array_equal(tnative.build_indptr(rows, 310),
                                  jnative.build_indptr(rows, 310))


def test_sample_unseen_rows():
    _, rows, cols = _events(1)
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)
    indptr = jnative.build_indptr(pairs[:, 0], 300)
    for seed in (0, 7):
        got = tnative.sample_unseen_rows(indptr, pairs[:, 1], 400, 5, seed)
        want = jnative.sample_unseen_rows(indptr, pairs[:, 1], 400, 5, seed)
        np.testing.assert_array_equal(got, want)


def test_split_top_continuous():
    rs = np.random.RandomState(2)
    tasks = rs.randint(0, 50, 2000)
    priorities = rs.randint(0, 30, 2000).astype(np.float64)
    assert (tnative.split_top_continuous(tasks, priorities)
            == jnative.split_top_continuous(tasks, priorities))


def test_row_unique_counts():
    _, rows, cols = _events(3)
    np.testing.assert_array_equal(tnative.row_unique_counts(rows, cols, 300),
                                  jnative.row_unique_counts(rows, cols, 300))


@pytest.mark.parametrize("tile_n", [128, 4096])
def test_pack_seen_bits(tile_n):
    _, rows, cols = _events(4, n_cols=9000)
    np.testing.assert_array_equal(
        tnative.pack_seen_bits(rows, cols, 300, 9000, tile_n=tile_n),
        jnative.pack_seen_bits(rows, cols, 300, 9000, tile_n=tile_n))


@pytest.mark.parametrize("k", [1, 3])
def test_group_top_k(k):
    rs = np.random.RandomState(5)
    groups = rs.randint(0, 200, 6000)
    values = rs.randint(1, 6, 6000).astype(np.float64)   # ties everywhere
    got = tnative.group_top_k(groups, values, 200, k)
    want = jnative.group_top_k(groups, values, 200, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_positions_equal_pandas_nlargest():
    """The selection and order of the native holdout path equal pandas
    ``groupby(sort=False).nlargest(keep="last")``, ties included."""
    rs = np.random.RandomState(6)
    groups = pd.Series(rs.permutation(np.repeat(np.arange(400), 10)))
    values = pd.Series(rs.randint(1, 6, 4000))
    want = values.groupby(groups, sort=False, group_keys=False).nlargest(
        2, keep="last").index.to_numpy()
    got = native_top_positions(groups.to_numpy(), values.to_numpy(), 2)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def large_frame():
    return make_synthetic_interactions(n_users=2500, n_items=600,
                                       n_events=130_000, seed=3)


@pytest.mark.parametrize("config", [
    dict(warm_start=False, test_ratio=0, holdout_size=2),
    dict(warm_start=True, test_ratio=0.9, test_fold=1, holdout_size=1)])
def test_prepare_takes_native_path_like_jax(large_frame, config):
    """Above 100k events both packages select the holdout natively; the
    holdout, the training frame and the test set are identical."""
    out = []
    for cls in (JaxData, TorchData):
        data = cls(large_frame.copy(), "userid", "movieid", "rating",
                   seed=0, verbose=False)
        for name, value in config.items():
            setattr(data, name, value)
        data.prepare()
        out.append(data)
    ref, port = out
    assert port.holdout_path == "native"
    pd.testing.assert_frame_equal(port.test.holdout, ref.test.holdout)
    pd.testing.assert_frame_equal(port.training, ref.training)
    if ref.test.testset is None:
        assert port.test.testset is None
    else:
        pd.testing.assert_frame_equal(port.test.testset, ref.test.testset)
