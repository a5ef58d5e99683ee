"""Chunked scoring loop and metric engine of the port against the JAX
package, from the same numpy test profiles and factors.

Factors are dyadic and feedback integral, so ``R @ V`` and the scores are
exact in f32 on both sides and recommendation ids must match exactly.
"""
import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp
import torch

from polara_tpu.evaluation import metrics as jmetrics
from polara_tpu.models.svd import SVDModel as JaxSVD
from polara_tpu.ops import scoring as jscoring
from polara_tpu_torch.evaluation import metrics as tmetrics
from polara_tpu_torch.models.svd import SVDModel as TorchSVD
from polara_tpu_torch.ops import scoring as tscoring


def _test_coo(seed=11, n_users=30, n_items=500, n_ev=1200):
    """User-sorted unique test profiles with Zipf-ish skewed item usage."""
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, n_users, n_ev)
    cols = np.minimum((rs.pareto(1.2, n_ev) * 8).astype(np.int64),
                      n_items - 1)
    pairs = np.unique(np.stack([rows, cols], 1), axis=0)
    vals = rs.randint(1, 6, len(pairs)).astype(np.float64)
    return pairs[:, 0], pairs[:, 1], vals


def _factors(seed, n_items, rank=8):
    rs = np.random.RandomState(seed)
    return np.clip(np.round(rs.randn(n_items, rank) * 4) / 4, -2, 2).astype(
        np.float32)


def _plans(rows, cols, vals, n_users, n_items, **kwargs):
    return (jscoring.ChunkedTestData.build(rows, cols, vals, n_users,
                                           n_items, **kwargs),
            tscoring.ChunkedTestData.build(rows, cols, vals, n_users,
                                           n_items, device="cpu", **kwargs))


@pytest.mark.parametrize("kwargs", [dict(), dict(chunk_users=7),
                                    dict(budget_gb=1e-5)])
def test_chunk_plans_identical(kwargs):
    rows, cols, vals = _test_coo()
    ref, port = _plans(rows, cols, vals, 30, 500, **kwargs)
    assert port.chunk_users == ref.chunk_users
    assert len(port.chunks) == len(ref.chunks)
    for jc, tc in zip(ref.chunks, port.chunks):
        assert tc.start == int(jc.start)
        for name in ("users", "user_valid", "rows", "cols", "vals", "valid"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)))
    np.testing.assert_array_equal(port.item_counts, ref.item_counts)
    for got, want in zip(port.pop_order(500), ref.pop_order(500)):
        np.testing.assert_array_equal(got, want)


def test_run_scoring_matches_jax():
    rows, cols, vals = _test_coo()
    ref, port = _plans(rows, cols, vals, 30, 500, chunk_users=8)
    v = _factors(0, 500)
    want = jscoring.run_scoring(ref, JaxSVD.score_chunk,
                                {"item_factors": jnp.asarray(v),
                                 "item_panel": jnp.asarray(v)},
                                topk=10, n_valid_cols=500)
    got = tscoring.run_scoring(port, TorchSVD.score_chunk,
                               {"item_factors": torch.as_tensor(v),
                                "item_panel": torch.as_tensor(v)},
                               topk=10, n_valid_cols=500)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("item_order", [None, "popularity"])
def test_run_scoring_fused_matches_jax(item_order):
    """Plain-path fused route vs the JAX fused route (Pallas interpret),
    in catalog and in popularity item order (ids mapped back)."""
    rows, cols, vals = _test_coo(seed=12)
    ref, port = _plans(rows, cols, vals, 30, 500)
    v = _factors(1, 500)
    want = jscoring.run_scoring_fused(
        ref, JaxSVD.proj_chunk, {"item_factors": jnp.asarray(v),
                                 "item_panel": jnp.asarray(v)},
        topk=10, n_valid_cols=500, interpret=True, item_order=item_order)
    got = tscoring.run_scoring_fused(
        port, TorchSVD.proj_chunk, {"item_factors": torch.as_tensor(v),
                                    "item_panel": torch.as_tensor(v)},
        topk=10, n_valid_cols=500, item_order=item_order)
    np.testing.assert_array_equal(got, want)


def test_popularity_order_ties_resolve_to_popular():
    """All scores tie: catalog order picks the lowest ids, popularity
    order the most popular item first — in both packages."""
    n_users, n_items = 4, 300
    rows = np.arange(n_users)
    cols = np.full(n_users, 250)
    ref, port = _plans(rows, cols, np.ones(n_users), n_users, n_items)
    got = {}
    for order in (None, "popularity"):
        got[order] = tscoring.run_scoring_fused(
            port, lambda p, c: torch.ones((c.users.shape[0], 4)),
            {"item_panel": torch.ones((n_items, 4))}, topk=3,
            filter_seen=False, n_valid_cols=n_items, item_order=order)
        want = jscoring.run_scoring_fused(
            ref, lambda p, c: jnp.ones((c.users.shape[0], 4), jnp.float32),
            {"item_panel": jnp.ones((n_items, 4), jnp.float32)}, topk=3,
            filter_seen=False, n_valid_cols=n_items, interpret=True,
            item_order=order)
        np.testing.assert_array_equal(got[order], want)
    np.testing.assert_array_equal(got[None][0], [0, 1, 2])
    assert got["popularity"][0][0] == 250


def _holdout_and_recs(seed=5, n_users=40, n_items=60):
    rs = np.random.RandomState(seed)
    users, items, ratings = [], [], []
    for u in range(n_users):
        picked = rs.choice(n_items, rs.randint(1, 5), replace=False)
        users += [u] * len(picked)
        items += list(picked)
        ratings += list(rs.randint(1, 6, len(picked)))
    holdout = pd.DataFrame({"userid": users, "movieid": items,
                            "rating": ratings})
    recs = np.stack([rs.choice(n_items, 10, replace=False)
                     for _ in range(n_users)]).astype(np.int32)
    hits = rs.rand(n_users) < 0.6          # plant hits at random ranks
    for u in np.flatnonzero(hits):
        row = holdout.movieid[holdout.userid == u].values
        recs[u, rs.randint(0, 10)] = row[0]
        recs[u] = np.r_[recs[u][np.sort(np.unique(recs[u],
                                                  return_index=True)[1])],
                        np.full(10, -1)][:10]
    recs[::7, 8:] = -1                     # short lists padded with PAD
    return holdout, recs


@pytest.mark.parametrize("variant", ["implicit", "polarity", "linear_top5"])
def test_compute_metrics_matches_jax(variant):
    holdout, recs = _holdout_and_recs()
    kwargs = dict(key="userid", target="movieid")
    if variant == "implicit":
        kwargs.update(not_rated_penalty=1.0)
    elif variant == "polarity":
        kwargs.update(feedback="rating", switch_positive=4,
                      is_positive=(holdout.rating >= 4).values,
                      coverage_total=60)
    else:
        recs = recs[:, :5]
        kwargs.update(feedback="rating", alternative=False,
                      not_rated_penalty=0.5, topk=5, coverage_total=60)
    want = jmetrics.compute_metrics(recs, holdout, **kwargs)
    got = tmetrics.compute_metrics(torch.as_tensor(recs), holdout, **kwargs)
    assert sorted(got) == sorted(want)
    for name in want:   # both sides f64: agreement to rounding
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   atol=1e-12, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("binary", [False, True])
def test_profile_matrix_matches_jax(binary):
    rows, cols, vals = _test_coo(seed=13)
    ref, port = _plans(rows, cols, vals, 30, 500, chunk_users=8)
    for jc, tc in zip(ref.chunks, port.chunks):
        np.testing.assert_array_equal(
            port.profile_matrix(tc, binary=binary).numpy(),
            np.asarray(ref.profile_matrix(jc, binary=binary)))
