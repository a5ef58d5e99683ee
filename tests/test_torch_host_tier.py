"""The port's host tier against the JAX package's, on the CPU: the
stateless preprocessing (frames and CSR matrices, ``RandomState``
samplers included), every dataset loader on a small archive that the test
writes, the import-path aliases and the runtime names."""
import gzip
import io
import json
import os
import tarfile
import zipfile

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import polara_tpu.datasets as jdatasets
import polara_tpu.preprocessing.dataframes as jdf
import polara_tpu.preprocessing.matrices as jmx
import polara_tpu.runtime as jruntime
import polara_tpu_torch
import polara_tpu_torch.datasets as tdatasets
import polara_tpu_torch.preprocessing.dataframes as tdf
import polara_tpu_torch.preprocessing.matrices as tmx
import polara_tpu_torch.runtime as truntime
from polara_tpu_torch.datasets.movielens import fetch_url
from polara_tpu_torch.ops.sparse import CooMatrix
from polara_tpu_torch.runtime.checkpoint import (load_factors_orbax,
                                                 save_factors_orbax)


def _log(n_users=40, n_items=30, seed=0, timestamps=True):
    rs = np.random.RandomState(seed)
    rows = [(u, i) for u in range(n_users)
            for i in rs.choice(n_items, rs.randint(3, 12), replace=False)]
    frame = pd.DataFrame(rows, columns=["userid", "itemid"])
    frame["rating"] = rs.randint(1, 6, len(frame))
    if timestamps:
        frame["timestamp"] = rs.permutation(len(frame))
    return frame


def _equal(got, want):
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    elif isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want)
    elif isinstance(want, pd.Index):
        pd.testing.assert_index_equal(got, want)
    elif sp.issparse(want):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert (got != want).nnz == 0
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


# --------------------------------------------------------------------------
# preprocessing.dataframes
# --------------------------------------------------------------------------

def _frame_calls(module, frame):
    users = pd.Index(frame["userid"].unique()[:30], name="userid")
    items = pd.Index(np.sort(frame["itemid"].unique())[:25], name="itemid")
    observed, holdout = module.split_holdout(frame, "userid", "rating",
                                             sample_max_rated=True,
                                             random_state=3)
    matrix = module.matrix_from_observations(
        frame, "userid", "itemid", user_index=users, item_index=items,
        feedback="rating")
    return {
        "reindex": module.reindex(frame, (users.copy(), items.copy())),
        "matrix_indexed": matrix,
        "matrix_fresh": module.matrix_from_observations(
            frame, "userid", "itemid", preserve_order=True),
        "split_random": module.split_holdout(frame, random_state=7),
        "split_max": (observed, holdout),
        "unseen": module.sample_unseen_interactions(
            frame, np.arange(30), n_random=5, random_state=11),
        "numeric": module.to_numeric_array(frame["userid"].astype(str)),
        "earliest_last": module.split_earliest_last(frame),
        "sessions": module.filter_sessions_by_length(
            frame, min_session_length=6),
    }


def test_dataframes_equal_jax(capsys):
    frame = _log()
    got = _frame_calls(tdf, frame)
    want = _frame_calls(jdf, frame)
    for name in want:
        _equal(got[name], want[name])
    observed, holdout = got["split_max"]
    tdf.verify_split(observed, holdout, False, "rating")
    capsys.readouterr()


def test_split_earliest_last_native_route_equals_jax():
    """Past 10,000 events the temporal split walks in the native
    library in both packages."""
    frame = _log(n_users=1500, n_items=200, seed=1)
    assert len(frame) >= 10_000
    _equal(tdf.split_earliest_last(frame), jdf.split_earliest_last(frame))


# --------------------------------------------------------------------------
# preprocessing.matrices
# --------------------------------------------------------------------------

def _csr(seed=2, n_users=30, n_items=60):
    rs = np.random.RandomState(seed)
    dense = (rs.rand(n_users, n_items) < 0.2) * rs.randint(1, 6, (n_users,
                                                                  n_items))
    dense[:, 0] = 5     # no empty row
    return sp.csr_matrix(dense.astype(np.float64))


@pytest.mark.parametrize("sample_max_rated", [True, False])
def test_matrices_samplers_equal_jax(sample_max_rated):
    matrix = _csr()
    hold = tmx.split_holdout(matrix, sample_max_rated, random_state=5)
    _equal(hold, jmx.split_holdout(matrix, sample_max_rated,
                                   random_state=5))
    _equal(tmx.mask_holdout(matrix, hold), jmx.mask_holdout(matrix, hold))
    _equal(tmx.sample_unseen(60, 10, np.arange(20), random_state=4),
           jmx.sample_unseen(60, 10, np.arange(20), random_state=4))
    _equal(tmx.sample_unseen_interactions(matrix, hold, size=20,
                                          random_state=6, chunk_rows=7),
           jmx.sample_unseen_interactions(matrix, hold, size=20,
                                          random_state=6, chunk_rows=7))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("binary", [True, False])
def test_rescale_matrix_equals_jax(axis, binary):
    matrix = _csr()
    got, got_s = tmx.rescale_matrix(matrix, 0.4, axis, binary,
                                    return_scaling_values=True)
    want, want_s = jmx.rescale_matrix(matrix, 0.4, axis, binary,
                                      return_scaling_values=True)
    _equal(got, want)
    _equal(got_s, want_s)
    assert tmx.rescale_matrix(matrix, 1, axis) is matrix


@pytest.mark.parametrize("axis", [0, 1])
def test_rescale_matrix_on_the_port_coo(axis):
    """The device COO matrix scales on its device: the scipy route's
    values in f32 (each factor rounded once, so within 1 ulp)."""
    matrix = _csr().tocoo()
    coo = CooMatrix.from_numpy(matrix.row, matrix.col,
                               matrix.data.astype(np.float32), matrix.shape,
                               device="cpu")
    scaled = tmx.rescale_matrix(coo, 0.4, axis)
    assert isinstance(scaled, CooMatrix)
    want = tmx.rescale_matrix(_csr(), 0.4, axis).toarray()
    np.testing.assert_allclose(scaled.to_dense().numpy(), want, rtol=2e-7)
    with pytest.raises(NotImplementedError):
        tmx.rescale_matrix(coo, 0.4, axis, return_scaling_values=True)


# --------------------------------------------------------------------------
# dataset loaders, each on an archive written here
# --------------------------------------------------------------------------

def _zip(path, members):
    with zipfile.ZipFile(path, "w") as zf:
        for name, text in members.items():
            zf.writestr(name, text)
    return str(path)


def _both(name, *args, **kwargs):
    got = getattr(tdatasets, name)(*args, **kwargs)
    want = getattr(jdatasets, name)(*args, **kwargs)
    _equal(got, want)
    return got


def _movielens_legacy(tmp_path):
    rs = np.random.RandomState(0)
    ratings = "\n".join(f"{u}::{m}::{rs.randint(1, 6)}::{978300000 + k}"
                        for k, (u, m) in enumerate(
                            (u, m) for u in range(1, 30)
                            for m in rs.choice(np.arange(1, 40), 6, False)))
    movies = "\n".join(f"{m}::Movie {m} (1999)::"
                       + "|".join(["Drama", "Comedy", "Action"][:m % 3 + 1])
                       for m in range(1, 40))
    tags = "\n".join(f"{u}::{u + 1}::tag {u}::{1000 + u}"
                     for u in range(1, 10))
    return _zip(tmp_path / "ml-1m.zip", {"ml-1m/ratings.dat": ratings,
                                         "ml-1m/movies.dat": movies,
                                         "ml-1m/tags.dat": tags})


@pytest.mark.parametrize("options", [
    dict(), dict(get_genres=True, include_time=True),
    dict(get_genres=True, split_genres=False, get_tags=True)])
def test_movielens_legacy_archive_equals_jax(tmp_path, options):
    _both("get_movielens_data", _movielens_legacy(tmp_path), **options)


def test_movielens_new_format_and_url(tmp_path):
    path = _zip(tmp_path / "ml-latest-small.zip", {
        "ml-latest-small/ratings.csv":
            "userId,movieId,rating,timestamp\n1,1,4.0,9\n1,3,4.5,8\n"
            "2,1,2.5,7\n",
        "ml-latest-small/movies.csv":
            "movieId,title,genres\n1,Toy Story (1995),Animation|Comedy\n"
            "3,\"Heat, The (1995)\",Action\n",
        "ml-latest-small/tags.csv":
            "userId,movieId,tag,timestamp\n1,1,pixar,5\n",
        "ml-latest-small/links.csv":
            "movieId,imdbId,tmdbId\n1,114709,862\n3,113277,949\n"})
    frames = _both("get_movielens_data", path, get_genres=True,
                   get_tags=True, mdb_mapping=True)
    assert len(frames) == 4
    fetched = fetch_url("file://" + os.path.abspath(path))
    _equal(tdatasets.get_movielens_data(fetched), frames[0])
    with pytest.raises(ValueError):
        tdatasets.get_movielens_data()


def test_filter_short_head_equals_jax():
    frame = _log().rename(columns={"itemid": "movieid"})
    _both("filter_short_head", frame, threshold=0.1)


def _tar(path, members, mode="w"):
    with tarfile.open(path, mode) as tar:
        for name, payload in members.items():
            if isinstance(payload, str):
                payload = payload.encode()
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return str(path)


def test_netflix_archive_equals_jax(tmp_path):
    inner = io.BytesIO()
    with tarfile.open(fileobj=inner, mode="w") as tar:
        for movie in (1, 2, 3):
            text = f"{movie}:\n" + "".join(
                f"{u},{(u + movie) % 5 + 1},2005-0{movie}-01\n"
                for u in range(10 * movie, 10 * movie + 4))
            info = tarfile.TarInfo(f"training_set/mv_{movie:07d}.txt")
            info.size = len(text)
            tar.addfile(info, io.BytesIO(text.encode()))
    path = _tar(tmp_path / "nf_prize_dataset.tar.gz", {
        "download/training_set.tar": inner.getvalue(),
        "download/probe.txt": "1:\n10\n11\n3:\n30\n"}, mode="w:gz")
    _both("get_netflix_data", path)
    _both("get_netflix_data", path, get_probe=True)


def test_bookcrossing_archive_equals_jax(tmp_path):
    path = _zip(tmp_path / "BX-CSV-Dump.zip", {
        "BX-Book-Ratings.csv": '"User-ID";"ISBN";"Book-Rating"\n'
                               '"1";"0195153448";"0"\n"2";"0002005018";"5"\n',
        "BX-Users.csv": '"User-ID";"Location";"Age"\n"1";"nyc, usa";NULL\n'
                        '"2";"stockton, california, usa";"18"\n',
        "BX-Books.csv": '"ISBN";"Book-Title";"Book-Author";'
                        '"Year-Of-Publication";"Publisher"\n'
                        '"0195153448";"Classical Mythology";"Mark P. O. '
                        'Morford";"2002";"Oxford University Press"\n'})
    _both("get_bookcrossing_data", path, get_users=True, get_books=True)
    with pytest.raises(ValueError):
        tdatasets.get_bookcrossing_data()


def test_amazon_files_equal_jax(tmp_path):
    ratings = tmp_path / "ratings.csv"
    ratings.write_text("A1,B001,5.0,1400000000\nA2,B002,3.0,1400000001\n"
                       "A1,B002,4.0,1400000002\n")
    meta = tmp_path / "meta.json.gz"
    with gzip.open(meta, "wt") as gz:
        gz.write("{'asin': 'B001', 'title': 'one', 'price': 3.5}\n")
        gz.write("{'asin': 'B002', 'categories': [['Books']]}\n")
    _both("get_amazon_data", str(ratings), str(meta))
    _both("get_amazon_data", str(ratings), nrows=2)
    _both("get_amazon_data", meta_path=str(meta), nrows=1)


def test_yahoo_archive_equals_jax(tmp_path):
    folder = "ydata-ymusic-user-song-ratings-meta-v1_0"
    path = _tar(tmp_path / "yahoo.tgz", {
        f"{folder}/train_0.txt": "0\t166\t5\n0\t2245\t1\n1\t3637\t4\n",
        f"{folder}/test_0.txt": "0\t7\t3\n1\t8\t2\n",
        f"{folder}/song-attributes.txt": "166\t1\t2\t3\n2245\t4\t5\t6\n",
        f"{folder}/genre-hierarchy.txt": "3\t0\t1\tRock\n6\t0\t1\tPop\n"},
        mode="w:gz")
    _both("get_yahoo_music_data", path, read_attributes=True,
          read_genres=True)
    _both("get_yahoo_music_data", path, include_test=False)


def test_epinions_files_equal_jax(tmp_path):
    ratings = tmp_path / "ratings_data.txt"
    ratings.write_text("header\n1 10 4\n1 11 5\n2 10 3\nfooter\n")
    trust = tmp_path / "trust_data.txt"
    trust.write_text("header\n 1 2 1\n 2 3 1\nfooter\n")
    _both("get_epinions_data", str(ratings), str(trust))


def test_top_level_loaders_and_recommender_aliases():
    for name in ("get_movielens_data", "get_netflix_data",
                 "get_bookcrossing_data", "get_amazon_data"):
        assert getattr(polara_tpu_torch, name) is getattr(tdatasets, name)
    from polara_tpu_torch import data, models
    from polara_tpu_torch.data.dataset import TestData
    from polara_tpu_torch.evaluation import metrics
    from polara_tpu_torch.models.baselines import NonPersonalized
    from polara_tpu_torch.recommender import data as rdata
    from polara_tpu_torch.recommender import evaluation as reval
    from polara_tpu_torch.recommender import models as rmodels
    for name in data.__all__:
        assert getattr(rdata, name) is getattr(data, name)
    for name in models.__all__:
        assert getattr(rmodels, name) is getattr(models, name)
    assert rdata.TestData is TestData
    assert rmodels.NonPersonalized is NonPersonalized
    assert rmodels.SVDModel.__module__ == "polara_tpu_torch.models.svd"
    for name in ("get_hr_score", "get_mrr_score", "compute_metrics",
                 "build_holdout_arrays"):
        assert getattr(reval, name) is getattr(metrics, name)


# --------------------------------------------------------------------------
# runtime names
# --------------------------------------------------------------------------

def test_runtime_rng_names():
    np.testing.assert_array_equal(truntime.random_seeds(5, entropy=42),
                                  jruntime.random_seeds(5, entropy=42))
    draws = [torch.rand(4, generator=truntime.key_from_seed(7, "cpu"))
             for _ in range(2)]
    assert torch.equal(*draws)
    gen = truntime.key_from_seed(None, device="cpu")
    assert gen.device == torch.device("cpu") and gen.initial_seed() == 0
    assert not torch.equal(
        torch.rand(4, generator=truntime.key_from_seed(8, "cpu")), draws[0])


def test_runtime_timing_names(tmp_path):
    out, seconds = truntime.timed_blocked(lambda x: x * 2,
                                          torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0)) and seconds >= 0
    with truntime.profiler_trace() as prof:
        assert prof is None
    with truntime.profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as handle:
        assert "traceEvents" in json.load(handle)
    assert prof.key_averages() is not None
    assert truntime.enable_compilation_cache() is None


def test_orbax_named_checkpoint_round_trip(tmp_path):
    factors = {"userid": None,
               "movieid": torch.arange(12, dtype=torch.float32).view(4, 3),
               "singular_values": torch.tensor([3.0, 2.0, 1.0])}
    path = str(tmp_path / "ckpt")
    save_factors_orbax(path, factors, {"rank": 3})
    loaded, meta = load_factors_orbax(path, device="cpu")
    assert meta == {"rank": 3} and loaded["userid"] is None
    for name in ("movieid", "singular_values"):
        assert torch.equal(loaded[name], factors[name])
