"""Experiment pipelines of the port (``evaluation.engine`` and
``evaluation.pipelines``) against ``polara_tpu``'s on the ``conftest.py``
fixture."""
import numpy as np
import pandas as pd
import pytest
import torch

from polara_tpu.evaluation import engine as jengine
from polara_tpu.evaluation import pipelines as jpipe
from polara_tpu.models import PopularityModel as JaxPop
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu_torch.evaluation import engine as tengine
from polara_tpu_torch.evaluation import pipelines as tpipe
from polara_tpu_torch.models import PopularityModel as TorchPop
from polara_tpu_torch.models import SVDModel as TorchSVD
from polara_tpu_torch.runtime.convert import factors_from_jax

from test_torch_svd_model import _jax_factors, _pair

RANKS = [2, 4, 6, 8]


def _svd_pair(frame, **config):
    """A JAX SVD model built at the top rank and a port model carrying its
    factors."""
    jdata, tdata = _pair(frame, **config)
    ref = JaxSVD(jdata)
    ref.verbose = False
    ref.rank = max(RANKS)
    ref.build()
    port = TorchSVD(tdata, device="cpu")
    port.verbose = False
    port.rank = max(RANKS)
    port.set_factors(factors_from_jax(_jax_factors(ref), device="cpu"))
    return ref, port


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("config", [dict(), dict(warm_start=False,
                                                 holdout_size=1)])
def test_svd_rank_sweep_matches_jax(synthetic_interactions, pad, config):
    """Per-rank scores within 1e-6 and the same best rank; the top-rank
    factors are restored after the sweep, and each rank's recommendations
    equal the JAX model's at that rank (ids bit for bit)."""
    ref, port = _svd_pair(synthetic_interactions, **config)
    target = "arhr" if config else "recall"
    want_best, want = jpipe.find_optimal_svd_rank(
        ref, RANKS, target, return_scores=True, pad_to_top_rank=pad)
    got_best, got = tpipe.find_optimal_svd_rank(
        port, RANKS, target, return_scores=True, pad_to_top_rank=pad)
    assert got_best == want_best
    assert list(got.index) == RANKS and got.name == want.name
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-6)
    assert port.rank == max(RANKS)
    assert port.factors["movieid"].shape[1] == max(RANKS)

    def ids_at(model, rank):
        saved = dict(model.factors)
        model.rank = rank
        recs = np.asarray(model.recommendations).copy()
        model._rank, model.factors = max(RANKS), saved
        model._recommendations = None
        return recs

    for rank in RANKS:
        np.testing.assert_array_equal(ids_at(port, rank), ids_at(ref, rank))


def test_mask_trailing_columns():
    rs = np.random.RandomState(0)
    factor = rs.randn(5, 6).astype(np.float32)
    got = tpipe._mask_trailing_columns(torch.as_tensor(factor), 4).numpy()
    want = np.asarray(jpipe._mask_trailing_columns(factor, 4))
    np.testing.assert_array_equal(got, want)
    assert not got[:, 4:].any()


def _pop_pair(frame, **config):
    jdata, tdata = _pair(frame, **config)
    ref, port = JaxPop(jdata), TorchPop(tdata, device="cpu")
    ref.verbose = port.verbose = False
    return ref, port


def test_cv_topk_table_matches_jax(synthetic_interactions):
    """``run_cv_experiment`` with ``topk_test`` over five folds: the same
    table (index, columns, values to 1e-9)."""
    ref, port = _pop_pair(synthetic_interactions)
    kwargs = dict(folds=[1, 2, 3, 4, 5], topk_list=[10, 5])
    want = jengine.run_cv_experiment([ref], fold_experiment=jengine.topk_test,
                                     **kwargs)
    got = tengine.run_cv_experiment([port], fold_experiment=tengine.topk_test,
                                    **kwargs)
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=0,
                                  atol=1e-9)


def test_holdout_test_matches_jax(synthetic_interactions):
    ref, port = _pop_pair(synthetic_interactions)
    want = jengine.holdout_test([ref], holdout_sizes=[1, 2], metrics="main")
    got = tengine.holdout_test([port], holdout_sizes=[1, 2], metrics="main")
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=0,
                                  atol=1e-9)


def test_random_grid_and_config_search_match_jax(synthetic_interactions):
    """The same two-point grid from the same seed, and the same scores and
    best configuration from ``find_optimal_config``."""
    params = {"by_feedback_value": [False, True], "topk": [10]}
    grid, names = tpipe.random_grid(params, n=0, seed=1)
    assert (grid, names) == jpipe.random_grid(params, n=0, seed=1)
    grid = sorted(grid)
    assert len(grid) == 2
    ref, port = _pop_pair(synthetic_interactions)
    want_best, want = jpipe.find_optimal_config(
        ref, grid, names, "precision", return_scores=True)
    got_best, got = tpipe.find_optimal_config(
        port, grid, names, "precision", return_scores=True)
    assert got_best == want_best
    pd.testing.assert_series_equal(got, want, check_exact=False, rtol=0,
                                   atol=1e-9)
