"""The port's ``ServingBundle`` against ``polara_tpu``'s on the CPU: the same
factors and requests through both bundles.

On the CPU the port's steps rank through the fused kernel's plain version
(``fused_score_topk_reference``).  Integer factors make every projection
and score exact in f32, so the projection steps must give identical ids,
ties and the ``lax.top_k`` fill of short rows included.  The fold-in steps
solve an f32 Cholesky system, which XLA and LAPACK round differently, so
their picks are held to the f64 solution's scores instead.  Each tolerance
is stated with its test."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu.models import CoffeeModel as JaxCoffee
from polara_tpu.runtime.serving import ServingBundle as JaxBundle
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.models import CoffeeModel, ImplicitALS, ImplicitBPR
from polara_tpu_torch.runtime import ServingBundle
from polara_tpu_torch.runtime.convert import factors_from_jax

N_ITEMS, RANK, BATCH, TOPK = 37, 5, 8, 10


def _integer_factors(seed, n_items=N_ITEMS, rank=RANK):
    return np.random.RandomState(seed).randint(
        -2, 3, (n_items, rank)).astype(np.float32)


def _requests(seed, n=21, n_items=N_ITEMS):
    """``n`` event lists and rating dicts (more than two batches), the
    last one seeing all but three items."""
    rs = np.random.RandomState(seed)
    lists = [rs.choice(n_items, rs.randint(1, 12), replace=False).tolist()
             for _ in range(n - 1)]
    lists.append(rs.permutation(n_items)[:n_items - 3].tolist())
    dicts = [{i: int(rs.randint(1, 6)) for i in e} for e in lists]
    return lists, dicts


def _profiles(dicts, n_items=N_ITEMS):
    out = np.zeros((len(dicts), n_items))
    for row, events in enumerate(dicts):
        out[row, list(events)] = list(events.values())
    return out


def _pair(factors, **kw):
    return (JaxBundle(factors, topk=TOPK, batch_size=BATCH, **kw),
            ServingBundle(factors, topk=TOPK, batch_size=BATCH, device="cpu",
                          **kw))


@pytest.mark.parametrize("left", [False, True], ids=["svd", "projectors"])
def test_projection_steps_match_jax_on_integer_factors(left):
    """Dense profiles, id lists, rating dicts and a mixed batch through
    both bundles (an asymmetric ``left_panel`` too): identical ids,
    including the short row's ``lax.top_k`` fill."""
    kw = {"left_panel": _integer_factors(9)} if left else {}
    jb, tb = _pair(_integer_factors(0), **kw)
    tb.warmup(event_widths=(16, 64), explicit_values=True)
    lists, dicts = _requests(1)
    mixed = [d if i % 2 else e for i, (e, d) in enumerate(zip(lists, dicts))]
    for requests in (lists, dicts, mixed):
        np.testing.assert_array_equal(tb.recommend_events(requests),
                                      jb.recommend_events(requests))
    profiles = _profiles(dicts)
    np.testing.assert_array_equal(tb.recommend(profiles),
                                  jb.recommend(profiles))
    np.testing.assert_array_equal(tb.recommend(torch.as_tensor(profiles)),
                                  jb.recommend(profiles))


def test_short_row_takes_seen_items_in_ascending_order():
    """13 items, top-10, a request that has seen all but three: the three
    unseen items by score, then the seen items in ascending id order (as
    ``lax.top_k`` fills -inf slots), on both steps and in the JAX
    bundle."""
    n_items = 13
    factors = _integer_factors(2, n_items=n_items)
    jb = JaxBundle(factors, topk=TOPK, batch_size=4)
    tb = ServingBundle(factors, topk=TOPK, batch_size=4, device="cpu")
    seen = [0, 2, 3, 4, 6, 7, 8, 10, 12, 5]
    got = tb.recommend_events([seen])[0]
    assert sorted(got[:3]) == [1, 9, 11]
    np.testing.assert_array_equal(got[3:], [0, 2, 3, 4, 5, 6, 7])
    np.testing.assert_array_equal(got, jb.recommend_events([seen])[0])
    profile = np.zeros((1, n_items))
    profile[0, seen] = 3
    np.testing.assert_array_equal(tb.recommend(profile), jb.recommend(
        profile))


def _onehot_factors(seed):
    """Integer factors with one nonzero per item: every fold-in system is
    diagonal."""
    rs = np.random.RandomState(seed)
    f = np.zeros((N_ITEMS, RANK), np.float32)
    f[np.arange(N_ITEMS), rs.randint(0, RANK, N_ITEMS)] = rs.choice(
        [-2, -1, 1, 2, 3], N_ITEMS)
    return f


def _foldin_scores(factors, spec, request):
    """f64 scores of one request's fold-in solution, seen items at -inf."""
    v = factors.astype(np.float64)
    ids = np.asarray(list(request))
    vals = (np.asarray(list(request.values()), np.float64)
            if isinstance(request, dict) else np.ones(len(ids)))
    reg = spec.get("reg", 0.01)
    if spec["kind"] == "ials":
        cm1 = np.log2(vals + 1.0)                 # alpha 1, eps 1, "log2"
        a = v.T @ v + reg * np.eye(RANK) + (v[ids].T * cm1) @ v[ids]
        rhs = (cm1 + 1.0) @ v[ids]
    else:
        a = reg * np.eye(RANK) + v[ids].T @ v[ids]
        rhs = v[ids].sum(0)
    scores = v @ np.linalg.solve(a, rhs)
    scores[ids] = -np.inf
    return scores


@pytest.mark.parametrize("kind", ["ials", "ridge"])
@pytest.mark.parametrize("step", ["events", "dense"])
def test_foldin_steps_match_jax(kind, step):
    """iALS confidence and BPR ridge fold-in, on event lists and dense
    profiles: each slot's pick of either bundle scores (f64 solution)
    within 1e-5 of the row's largest |score| of the f64 top-k at that
    slot; the short row's fill is exact."""
    factors = _onehot_factors(3)
    spec = {"kind": kind}
    jb, tb = _pair(factors, fold_in=spec)
    lists, dicts = _requests(4)
    requests = lists if kind == "ridge" else dicts
    if step == "events":
        got, want = (b.recommend_events(requests) for b in (tb, jb))
    else:
        profiles = _profiles(dicts)
        got, want = (b.recommend(profiles) for b in (tb, jb))
        requests = dicts
    for row, request in enumerate(requests[:-1]):
        scores = _foldin_scores(factors, spec, request)
        best = np.sort(scores)[::-1][:TOPK]
        scale = np.abs(scores[np.isfinite(scores)]).max()
        for picks in (got[row], want[row]):
            assert np.all(np.abs(scores[picks] - best) <= 1e-5 * scale)
    np.testing.assert_array_equal(got[-1][3:], want[-1][3:])


@pytest.fixture(scope="module")
def coffee_pair():
    """A JAX and a port CoFFee model with the same dyadic factors."""
    events = make_synthetic_interactions(n_users=60, n_items=30,
                                         n_events=1200, seed=0)
    out = []
    for cls in (JaxData, TorchData):
        data = cls(events.copy(), "userid", "movieid", "rating", seed=0,
                   verbose=False)
        data.warm_start = False
        data.holdout_size = 1
        data.prepare()
        out.append(data)
    jdata, tdata = out
    _, _, shape = jdata.to_coo(tensor_mode=True)
    rs = np.random.RandomState(5)
    mlrank = (4, 3, 2)
    factors = {name: np.round(rs.randn(n, r) * 4) / 4 for name, n, r in
               zip(jdata.fields, shape, mlrank)}
    factors["core"] = np.round(rs.randn(*mlrank) * 4) / 4
    jax_model = JaxCoffee(jdata)
    jax_model.mlrank = mlrank
    jax_model.factors = {k: jnp.asarray(v, jnp.float32)
                         for k, v in factors.items()}
    port = CoffeeModel(tdata, device="cpu")
    port.mlrank = mlrank
    port.set_factors(factors_from_jax(factors, device="cpu"))
    return jax_model, port


def test_coffee_bundle_from_model_matches_jax(coffee_pair):
    """``from_model`` on CoFFee: the same value map and default weight;
    identical ids for rating dicts, id lists (the top level's weight), a
    mixed batch and dense profiles (routed through the event path, seen
    keyed on the ids: level weights can be negative)."""
    jax_model, port = coffee_pair
    jb = JaxBundle.from_model(jax_model, batch_size=BATCH)
    tb = ServingBundle.from_model(port, batch_size=BATCH)
    assert tb.value_map == jb.value_map
    assert tb.default_weight == jb.default_weight
    lists, dicts = _requests(6, n_items=tb.n_items)
    mixed = [d if i % 3 else e for i, (e, d) in enumerate(zip(lists, dicts))]
    for requests in (dicts, lists, mixed):
        np.testing.assert_array_equal(tb.recommend_events(requests),
                                      jb.recommend_events(requests))
    profiles = _profiles(dicts, n_items=tb.n_items)
    np.testing.assert_array_equal(tb.recommend(profiles),
                                  jb.recommend(profiles))


def test_requests_are_validated_as_in_jax(coffee_pair):
    jax_model, port = coffee_pair
    bundles = (JaxBundle.from_model(jax_model, batch_size=BATCH),
               ServingBundle.from_model(port, batch_size=BATCH))
    for bundle in bundles:
        with pytest.raises(ValueError, match="absent from the trained"):
            bundle.recommend_events([{0: 5}, {1: 2.5}])
        with pytest.raises(ValueError, match="must lie in"):
            bundle.recommend_events([[0, bundle.n_items]])
        with pytest.raises(ValueError, match="must lie in"):
            bundle.recommend_events([[-1, 2]])
        assert bundle.recommend_events([]).shape == (0, bundle.topk)
    factors = _integer_factors(0)
    for cls, kw in ((JaxBundle, {}), (ServingBundle, {"device": "cpu"})):
        with pytest.raises(ValueError, match="mutually exclusive"):
            cls(factors, fold_in={"kind": "ridge"}, value_map={1.0: 1.0},
                **kw)
        with pytest.raises(ValueError, match="unknown fold_in kind"):
            cls(factors, fold_in={"kind": "svd"}, **kw)
        with pytest.raises(ValueError, match="ambiguous"):
            cls(factors, **kw).recommend([list(range(N_ITEMS))])


def test_fold_in_weight_callable_is_checked_at_construction():
    """A callable confidence weight runs once on a 1-element tensor: one
    of torch tensors serves like its named twin; one that fails on a
    tensor raises ``ValueError`` at construction."""
    factors = _onehot_factors(3)
    named = ServingBundle(factors, device="cpu", batch_size=BATCH,
                          fold_in={"kind": "ials", "weight": "linear"})
    lam = ServingBundle(factors, device="cpu", batch_size=BATCH,
                        fold_in={"kind": "ials", "weight": lambda x: x})
    lists, dicts = _requests(7)
    np.testing.assert_array_equal(lam.recommend_events(dicts),
                                  named.recommend_events(dicts))
    with pytest.raises(ValueError, match="callable"):
        ServingBundle(factors, device="cpu", fold_in={
            "kind": "ials", "weight": lambda x: np.asarray(x) + 1.0})
    with pytest.raises(ValueError, match="custom callable"):
        lam.save("unused.npz")


@pytest.mark.parametrize("kind", ["plain", "value_map", "fold_in"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_saved_bundles_load_in_the_other_package(tmp_path, kind,
                                                 direction):
    """A bundle saved by either package loads in the other and serves
    identical ids (integer factors; the fold-in bundle on one-hot
    factors, compared on the short row's exact fill and by equal
    settings)."""
    factors = _onehot_factors(3) if kind == "fold_in" else \
        _integer_factors(8)
    kw = {"plain": {"left_panel": _integer_factors(9)},
          "value_map": {"value_map": {1.0: -0.5, 3.0: 0.25, 5.0: 2.0},
                        "default_weight": 2.0},
          "fold_in": {"fold_in": {"kind": "ials", "alpha": 2.0,
                                  "weight": "sqrt", "reg": 0.5}}}[kind]
    jb, tb = _pair(factors, **kw)
    path = str(tmp_path / "bundle.npz")
    if direction == "jax_to_torch":
        jb.save(path)
        saved, loaded = jb, ServingBundle.load(path, device="cpu")
    else:
        tb.save(path)
        saved, loaded = tb, JaxBundle.load(path)
    assert (loaded.topk, loaded.batch_size, loaded.value_map,
            loaded.default_weight, loaded.fold_in) == (
        saved.topk, saved.batch_size, saved.value_map,
        saved.default_weight, saved.fold_in)
    lists, dicts = _requests(9)
    requests = [{i: 3 for i in e} for e in lists] \
        if kind == "value_map" else dicts
    got, want = (b.recommend_events(requests) for b in (loaded, saved))
    if kind == "fold_in":
        np.testing.assert_array_equal(got[-1][3:], want[-1][3:])
        loaded_twin = (tb if direction == "jax_to_torch" else jb)
        np.testing.assert_array_equal(
            got, loaded_twin.recommend_events(requests))
    else:
        np.testing.assert_array_equal(got, want)


def test_topk_above_the_kernel_limit_takes_the_plain_route():
    """k = 130 > 128 over 300 items: the stable-sort route, ids identical
    to the JAX bundle's (short row filled by seen items ascending)."""
    factors = _integer_factors(10, n_items=300, rank=4)
    jb = JaxBundle(factors, topk=130, batch_size=4)
    tb = ServingBundle(factors, topk=130, batch_size=4, device="cpu")
    rs = np.random.RandomState(11)
    requests = [rs.choice(300, 40, replace=False).tolist()
                for _ in range(5)]
    requests.append(list(range(200)))
    np.testing.assert_array_equal(tb.recommend_events(requests),
                                  jb.recommend_events(requests))


@pytest.mark.parametrize("cls,kind", [(ImplicitALS, "ials"),
                                      (ImplicitBPR, "ridge")])
def test_implicit_models_bundle_their_fold_in(cls, kind):
    """``from_model`` on iALS and BPR carries the model's own fold-in
    settings and serves like a bundle built from them directly."""
    data = TorchData(make_synthetic_interactions(n_users=40, n_items=N_ITEMS,
                                                 n_events=600, seed=1),
                     "userid", "movieid", "rating", seed=0, verbose=False)
    data.prepare()
    model = cls(data, device="cpu")
    model.rank = RANK
    model.regularization = 0.5
    userid, itemid, _ = data.fields
    n_items = data.index.itemid.shape[0]
    model.set_factors({itemid: torch.as_tensor(
        _onehot_factors(3)[:n_items]), userid: None})
    bundle = ServingBundle.from_model(model, batch_size=BATCH)
    assert bundle.fold_in["kind"] == kind and bundle.fold_in["reg"] == 0.5
    direct = ServingBundle(model.factors[itemid], batch_size=BATCH,
                           fold_in=bundle.fold_in)
    lists, _ = _requests(12, n_items=n_items)
    np.testing.assert_array_equal(bundle.recommend_events(lists),
                                  direct.recommend_events(lists))
