"""The evaluation protocols of the port against the JAX package's, on the
CPU: sampled-candidate evaluation (registered lists and on-the-fly
samples), the long-tail holdout on both holdout routes, and contextual
post-filtering.  Factors are dyadic (multiples of 1/4) and feedback is
integer, so every f32 score is exact in both packages and ids must match
bit for bit, ties included."""
import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp
import torch

import polara_tpu.config as jconfig
from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.data.contextual import ItemPostFilteringData as JaxCtxData
from polara_tpu.data.mixins import LongTailMixin as JaxLongTail
from polara_tpu.data.mixins import SampledEvaluationMixin as JaxSampledData
from polara_tpu.models.contextual import ItemPostFilteringMixin as JaxCtxMix
from polara_tpu.models.sampled import SampledEvaluationSVDMixin as JaxSampled
from polara_tpu.models.svd import SVDModel as JaxSVD
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.data import (ItemPostFilteringData, LongTailMixin,
                                   RecommenderData, SampledEvaluationMixin)
from polara_tpu_torch.data import dataset as tdataset
from polara_tpu_torch.models import ItemPostFilteringMixin, SVDModel
from polara_tpu_torch.models.sampled import SampledEvaluationSVDMixin
from polara_tpu_torch.ops.fused_topk import fused_score_topk
from polara_tpu_torch.runtime.convert import factors_from_jax

RANK = 6


class JSampledData(JaxSampledData, JaxData):
    pass


class TSampledData(SampledEvaluationMixin, RecommenderData):
    pass


class JSampledSVD(JaxSampled, JaxSVD):
    pass


class TSampledSVD(SampledEvaluationSVDMixin, SVDModel):
    pass


class JLongTail(JaxLongTail, JaxData):
    pass


class TLongTail(LongTailMixin, RecommenderData):
    pass


class JCtxSVD(JaxCtxMix, JaxSVD):
    pass


class TCtxSVD(ItemPostFilteringMixin, SVDModel):
    pass


def _events(n_users=60, n_items=40, per_user=12, seed=0):
    """Every user rates exactly ``per_user`` items (ratings 1..5), so with
    one held-out item every test user has the same unseen count."""
    rs = np.random.RandomState(seed)
    rows = [(u, i, rs.randint(1, 6)) for u in range(n_users)
            for i in rs.choice(n_items, per_user, replace=False)]
    return pd.DataFrame(rows, columns=["userid", "movieid", "rating"])


def _prepared(cls, frame, **config):
    data = cls(frame.copy(), "userid", "movieid", "rating", seed=0,
               verbose=False, **config.pop("init", {}))
    for name, value in config.items():
        setattr(data, name, value)
    data.prepare()
    return data


def _dyadic(shape, seed):
    rs = np.random.RandomState(seed)
    return np.clip(np.round(rs.randn(*shape) * 4) / 4, -2, 2)


def _models(jcls, tcls, jdata, tdata, seed=1):
    """A JAX model and its port twin sharing dyadic item factors."""
    n_items = len(jdata.get_entity_index("movieid"))
    factors = {"userid": None, "movieid": _dyadic((n_items, RANK), seed),
               "singular_values": np.ones(RANK)}
    jmodel = jcls(jdata)
    jmodel.verbose = False
    jmodel.rank = RANK
    jmodel.factors = {k: None if v is None else jnp.asarray(v)
                      for k, v in factors.items()}
    jmodel._is_ready = True
    tmodel = tcls(tdata, device="cpu")
    tmodel.verbose = False
    tmodel.set_factors(factors_from_jax(factors, device="cpu"))
    return jmodel, tmodel


SAMPLED = dict(warm_start=False, holdout_size=1, test_ratio=0.2)


def _registered_lists(data, n_unseen, seed=5):
    """External-id unseen lists for every user of the index: items outside
    the user's training, test profile and holdout."""
    rs = np.random.RandomState(seed)
    userid, itemid = "userid", "movieid"
    users = data.get_entity_index(userid).set_index("new")["old"]
    items = data.get_entity_index(itemid).set_index("new")["old"]
    seen = pd.concat([data.training, data.test.holdout]).groupby(
        userid)[itemid].apply(set)
    lists = {}
    for user, user_seen in seen.items():
        pool = [i for i in range(len(items)) if i not in user_seen]
        lists[users.loc[user]] = items.loc[
            rs.permutation(pool)[:n_unseen]].values
    return pd.Series(lists)


def test_sampled_registered_lists_match_jax():
    frame = _events()
    jdata = _prepared(JSampledData, frame, **SAMPLED)
    tdata = _prepared(TSampledData, frame, **SAMPLED)
    lists = _registered_lists(tdata, 9)
    jdata.set_unseen_interactions(lists)
    tdata.set_unseen_interactions(lists)
    pd.testing.assert_series_equal(
        tdata.unseen_interactions.apply(list),
        jdata.unseen_interactions.apply(list))
    pd.testing.assert_frame_equal(tdata.test.holdout, jdata.test.holdout)
    jmodel, tmodel = _models(JSampledSVD, TSampledSVD, jdata, tdata)
    want = np.asarray(jmodel.recommendations)
    got = tmodel.recommendations
    n_test = tdata.test.holdout["userid"].nunique()
    assert got.shape == want.shape == (n_test, tmodel.topk)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(tmodel.evaluate(["relevance", "ranking"]),
                    jmodel.evaluate(["relevance", "ranking"])):
        for name, value in w._asdict().items():
            np.testing.assert_allclose(getattr(g, name), value, rtol=0,
                                       atol=1e-12)


def test_sampled_on_the_fly_full_unseen_set_matches_jax():
    """With every unseen item sampled the candidate set is fixed, so the
    holdout's rank, hence HR and MRR, cannot depend on the draw; the
    sampled columns' order can."""
    frame = _events()
    jdata = _prepared(JSampledData, frame, **SAMPLED)
    tdata = _prepared(TSampledData, frame, **SAMPLED)
    n_items = tdata.get_test_shape()[1]
    holdout = tdata.test.holdout
    test_users = tdata.training["userid"].isin(holdout["userid"])
    per_user = pd.concat([tdata.training[test_users], holdout]) \
        .groupby("userid").size()
    assert per_user.nunique() == 1
    n_unseen = n_items - int(per_user.iloc[0])
    jdata.unseen_items_num = tdata.unseen_items_num = n_unseen
    jmodel, tmodel = _models(JSampledSVD, TSampledSVD, jdata, tdata, seed=2)
    tmodel.topk = jmodel.topk = n_unseen + 1
    want = np.asarray(jmodel.recommendations)
    got = tmodel.recommendations
    np.testing.assert_array_equal(np.argmax(got == 0, axis=1),
                                  np.argmax(want == 0, axis=1))
    for g, w in zip(tmodel.evaluate(["relevance", "ranking"], topk=10),
                    jmodel.evaluate(["relevance", "ranking"], topk=10)):
        for name, value in w._asdict().items():
            np.testing.assert_allclose(getattr(g, name), value, rtol=0,
                                       atol=1e-12)
    # two runs from the data's seed draw the same candidates
    tmodel._recommendations = None
    np.testing.assert_array_equal(tmodel.recommendations, got)


@pytest.mark.parametrize("route", ["pandas", "native"])
@pytest.mark.parametrize("tail", [
    dict(head_feedback_frac=0.33), dict(head_items_frac=0.1),
    dict(short_head_items=[0, 1, 2, 3, 5, 8])])
def test_long_tail_holdout_matches_jax(monkeypatch, route, tail):
    """The narrowed split reaches both holdout routes: the port's native
    route (threshold lowered to this log) picks the JAX package's pandas
    holdout."""
    if route == "native":
        monkeypatch.setattr(tdataset, "NATIVE_HOLDOUT_MIN_EVENTS", 1)
    frame = _events(n_users=80, n_items=50, per_user=15, seed=3)
    config = dict(init=dict(long_tail_holdout=True, **tail),
                  warm_start=False, holdout_size=1, test_ratio=0.2)
    jdata = _prepared(JLongTail, frame, **dict(config, init=dict(
        config["init"])))
    tdata = _prepared(TLongTail, frame, **config)
    assert tdata.holdout_path == route
    pd.testing.assert_frame_equal(tdata.test.holdout, jdata.test.holdout)
    pd.testing.assert_frame_equal(tdata.training, jdata.training)
    head = set(tail.get("short_head_items", []))
    if head:
        items = tdata.get_entity_index("movieid").set_index("new")["old"]
        assert not head & set(items.loc[tdata.test.holdout["movieid"]])


def _context_frames(n_users=70, n_items=40, seed=0):
    rs = np.random.RandomState(seed)
    genres = np.array(["action", "comedy", "drama", "noir"])
    item_genre = genres[rs.randint(0, len(genres), n_items)]
    rows = []
    for user in range(n_users):
        for item in rs.choice(n_items, size=rs.randint(5, 12),
                              replace=False):
            rows.append((user, item, rs.randint(1, 6), item_genre[item]))
    events = pd.DataFrame(rows,
                          columns=["userid", "movieid", "rating", "genre"])
    mapping = pd.DataFrame({"movieid": np.arange(n_items),
                            "genre": item_genre})
    return events, mapping


CONTEXT = dict(holdout_size=1, test_ratio=0.2)


def _context_pair():
    events, mapping = _context_frames()
    init = dict(item_context_mapping={"genre": mapping})
    return (_prepared(JaxCtxData, events, init=dict(init), **CONTEXT),
            _prepared(ItemPostFilteringData, events, init=dict(init),
                      **CONTEXT))


def test_context_data_and_upvote_arrays_match_jax():
    jdata, tdata = _context_pair()
    for key in ("userid", "movieid"):
        pd.testing.assert_series_equal(tdata.context_data["genre"][key],
                                       jdata.context_data["genre"][key])
    for got, want in zip(tdata.upvote_arrays(), jdata.upvote_arrays()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def two_chunk_budget():
    """A score budget that cuts the test users into several chunks in
    both packages (the boost's maximum is per chunk)."""
    saved = (jconfig.get_default("hbm_score_budget_gb"),
             tconfig.get_default("hbm_score_budget_gb"),
             tconfig.get_default("fused_scoring"))
    budget = 8 * 40 * 4 / 2 ** 30        # 8 users x 40 items in f32
    jconfig.set_default("hbm_score_budget_gb", budget)
    tconfig.set_default("hbm_score_budget_gb", budget)
    tconfig.set_default("fused_scoring", True)
    yield
    jconfig.set_default("hbm_score_budget_gb", saved[0])
    tconfig.set_default("hbm_score_budget_gb", saved[1])
    tconfig.set_default("fused_scoring", saved[2])


@pytest.mark.parametrize("filter_seen", [True, False])
def test_contextual_model_matches_jax_and_stays_unfused(two_chunk_budget,
                                                        filter_seen):
    jdata, tdata = _context_pair()
    jmodel, tmodel = _models(JCtxSVD, TCtxSVD, jdata, tdata, seed=4)
    jmodel.filter_seen = tmodel.filter_seen = filter_seen
    jmodel.topk = tmodel.topk = 15
    before = fused_score_topk.launches
    got = tmodel.recommendations
    assert len(tmodel._test_plan.chunks) >= 2
    assert not tmodel.uses_fused_scoring(tmodel.score_params())
    assert fused_score_topk.launches == before
    np.testing.assert_array_equal(got, np.asarray(jmodel.recommendations))
    assert (jmodel._test_plan.chunk_users == tmodel._test_plan.chunk_users
            < tmodel._test_plan.n_users)
    # the plain SVD twin on the same factors does take the fused route
    plain = SVDModel(tdata, device="cpu")
    plain.set_factors(tmodel.factors)
    assert plain.uses_fused_scoring(plain.score_params())
    items, valid = (torch.as_tensor(a) for a in tdata.upvote_arrays())
    boosted = (got[:, :1] == items.numpy()) & valid.numpy()
    assert boosted.any(axis=1)[valid.any(1).numpy()].mean() > 0.9
