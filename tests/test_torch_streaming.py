"""The port's streaming tier on one device (``ops/sparse.py``'s chunked,
tiled and split-head operators, ``SVDModel``'s and ``ImplicitALS``'s
routing past the memory budget), the numpy generators, the runtime
helpers and ``result_from_jax``, against ``polara_tpu`` on the same numpy
inputs.

With integer ratings and integer panels every f32 sum is exact, so each
operator's ``mm``/``rmm`` equals the JAX operator's and the dense product
bit for bit, whatever the order of its sums."""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polara_tpu import config as jconfig
from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import synthetic as jsyn
from polara_tpu.models import ImplicitALS as JaxALS
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu.ops import implicit as jimplicit
from polara_tpu.ops import rsvd as jrsvd
from polara_tpu.ops import sparse as js
from polara_tpu.runtime import memory as jmem
from polara_tpu_torch import config as tconfig
from polara_tpu_torch import runtime as truntime
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.datasets import synthetic as tsyn
from polara_tpu_torch.models import ImplicitALS as TorchALS
from polara_tpu_torch.models import SVDModel as TorchSVD
from polara_tpu_torch.models import svd as tsvd_module
from polara_tpu_torch.ops import implicit as timplicit
from polara_tpu_torch.ops import sparse as ts
from polara_tpu_torch.runtime.convert import result_from_jax


def _skewed(m=160, n=60, n_events=900, seed=11, integer=True):
    """The JAX tests' Zipf-ish events (duplicate pairs add)."""
    rs = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, n + 1) ** 0.9
    cols = rs.choice(n, size=n_events, p=w / w.sum()).astype(np.int32)
    rows = rs.randint(0, m, n_events).astype(np.int32)
    vals = rs.randint(1, 6, n_events).astype(np.float64)
    if not integer:
        vals = vals + rs.rand(n_events)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    return rows, cols, vals, dense


def _panels(m, n, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randint(-3, 4, (n, 7)).astype(np.float32),
            rs.randint(-3, 4, (m, 5)).astype(np.float32))


def _assert_products(jop, top, dense, x, y):
    """mm and rmm: the port's equal the JAX operator's and the dense
    product bit for bit (integer data)."""
    got_mm = top.mm(torch.as_tensor(x)).numpy()
    got_rmm = top.rmm(torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(got_mm, (dense @ x).astype(np.float32))
    np.testing.assert_array_equal(got_rmm, (dense.T @ y).astype(np.float32))
    if jop is not None:
        np.testing.assert_array_equal(got_mm,
                                      np.asarray(jop.mm(jnp.asarray(x))))
        np.testing.assert_array_equal(got_rmm,
                                      np.asarray(jop.rmm(jnp.asarray(y))))


# (kind, keyword arguments, compare with the JAX operator too): the JAX
# package's staging compiles for seconds per layout, so three cases cover
# its layouts (the split case's tail is its tiled layout at two tile
# sizes) and the rest are held to the dense products, which the JAX
# operators equal by the JAX package's own tests
OPERATOR_CASES = (
    [("chunked", dict(event_chunk=c), c == 37) for c in (1, 37, 256, 10 ** 9)]
    + [("tiled", dict(tile=t, event_chunk=c), t == 8)
       for t, c in ((1, 5), (4, 16), (8, 56), (16, 10 ** 9), (128, 256))]
    + [("split", dict(head_items=h, event_chunk=64, tile=8), False)
       for h in (8, 60)]
    # the auto head width: a budget of exactly 31 int8 columns
    + [("split", dict(head_budget_gb=(31 * 160 + 0.5) / 2 ** 30,
                      event_chunk=64, tile=8), True)]
    + [("split", dict(head_items=24, head_block_rows=64, event_chunk=128,
                      tile=8), False)])


@pytest.mark.parametrize("kind,kw,vs_jax", OPERATOR_CASES,
                         ids=[f"{k}-{i}" for i, (k, _, _) in
                              enumerate(OPERATOR_CASES)])
def test_operator_products_equal_jax_and_dense(kind, kw, vs_jax):
    """Chunk sizes from one event per chunk to one chunk, tiles from 1 to
    past the longest list, heads of 8 items to the whole catalog and of
    the auto width, a head of 64-row blocks over 160 rows (a padded last
    block).  The split head is int8, equal to the dense block's head
    columns, and (against JAX) the same block, width and ``head_ids``."""
    rows, cols, vals, dense = _skewed()
    top = getattr(ts, f"{kind}_coo_operator")(
        rows, cols, vals, dense.shape, device="cpu", **kw)
    jop = (getattr(js, f"{kind}_coo_operator")(rows, cols, vals,
                                                dense.shape, **kw)
           if vs_jax else None)
    _assert_products(jop, top, dense, *_panels(*dense.shape))
    if kind == "split":
        d, head_ids = top.operands[0]
        assert d.dtype == torch.int8 and d.dim() == 3
        head = d.reshape(-1, d.shape[2])[:dense.shape[0]]
        np.testing.assert_array_equal(head.numpy(),
                                      dense[:, head_ids.numpy()])
        if jop is not None:
            assert d.shape[2] == 31
            np.testing.assert_array_equal(d.numpy(),
                                          np.asarray(jop.operands[0][0]))
            np.testing.assert_array_equal(head_ids.numpy(),
                                          np.asarray(jop.operands[0][1]))


@pytest.mark.parametrize("kind", ["chunked", "tiled", "split"])
def test_unsorted_uint32_events_sort_on_staging(kind):
    """Unsorted uint32 ids (a wrapping diff would call them sorted):
    each operator sorts them and still equals the dense products."""
    rows, cols, vals, dense = _skewed()
    perm = np.random.RandomState(8).permutation(len(rows))
    kw = dict(head_items=16, tile=8) if kind == "split" else {}
    top = getattr(ts, f"{kind}_coo_operator")(
        rows[perm].astype(np.uint32), cols[perm].astype(np.uint32),
        vals[perm], dense.shape, event_chunk=64, device="cpu", **kw)
    _assert_products(None, top, dense, *_panels(*dense.shape))


def test_tiled_padding_empty_entities_and_a_hot_row():
    """Rows and columns without events (the trailing ones too) give zero
    rows; one row with more events than a chunk accumulates across
    chunks; padding slots add nothing."""
    rs = np.random.RandomState(3)
    m, n = 41, 29
    rows = np.concatenate([rs.randint(0, m - 5, 150),
                           np.full(100, 7)]).astype(np.int32)
    cols = rs.randint(0, n - 3, 250).astype(np.int32)
    vals = rs.randint(-4, 6, 250).astype(np.float64)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    top = ts.tiled_coo_operator(rows, cols, vals, (m, n), event_chunk=16,
                                tile=4, device="cpu")
    _assert_products(None, top, dense, *_panels(m, n))
    row_side = top.operands[0]
    assert row_side.minor.shape[0] % 4 == 0 and len(row_side.chunks) > 1


def test_split_head_only_and_tail_only():
    """A head over every item keeps no tail sides; ``head_items=0`` and a
    ``min_coverage`` the head cannot reach both fall back to the tiled
    operator at ``col_tile``."""
    rows, cols, vals, dense = _skewed(n=24)
    top = ts.split_coo_operator(rows, cols, vals, dense.shape,
                                head_items=24, device="cpu")
    assert top.operands[1] is None and top.operands[2] is None
    _assert_products(None, top, dense, *_panels(*dense.shape))
    for kw in (dict(head_items=0), dict(head_items=4, min_coverage=0.9)):
        top = ts.split_coo_operator(rows, cols, vals, dense.shape,
                                    col_tile=16, device="cpu", **kw)
        assert top.mm_fn is ts._tiled_mm and top.operands[0].tile == 16
        _assert_products(None, top, dense, *_panels(*dense.shape))


def test_column_grouped_head_equals_one_group():
    """A small ``_max_flat_cells`` builds the head in column groups of 7:
    the same block as one group."""
    rows, cols, vals, dense = _skewed()
    kw = dict(head_items=24, event_chunk=128, tile=8)
    one = ts.split_coo_operator(rows, cols, vals, dense.shape,
                                device="cpu", **kw)
    grouped = ts.split_coo_operator(rows, cols, vals, dense.shape,
                                    _max_flat_cells=dense.shape[0] * 7,
                                    device="cpu", **kw)
    assert torch.equal(one.operands[0][0], grouped.operands[0][0])
    _assert_products(None, grouped, dense, *_panels(*dense.shape))


def _head_events(seed, extra=0):
    """Head events over 300 rows x 37 head columns, ``extra`` duplicates
    of one 5-star cell on top."""
    rows, cols, vals, _ = _skewed(m=300, n=900, n_events=6000, seed=seed)
    rows = np.concatenate([rows, np.full(extra, 3, np.int32)])
    hp = np.concatenate([cols % 37, np.full(extra, 5)]).astype(np.int32)
    vals = np.concatenate([vals, np.full(extra, 5.0)])
    return rows, hp, vals


@pytest.mark.parametrize("extra,groups_of,want_dtype", [
    (0, None, torch.int8), (0, 7, torch.int8), (40, 7, torch.float32)])
def test_build_head_block_equals_jax(extra, groups_of, want_dtype):
    """``build_head_block`` on the same head events equals the JAX
    package's, in one group and in column groups of 7; 40 duplicate
    5-star events on one cell sum to 200 (> 127) and demote the whole
    block to the compute dtype (only the last group overflows)."""
    rows, hp, vals = _head_events(seed=5, extra=extra)
    cells = 2 ** 31 - 1 if groups_of is None else 320 * groups_of
    want = js.build_head_block(jnp.asarray(rows), jnp.asarray(hp),
                               jnp.asarray(vals, jnp.float32), 320, 37,
                               jnp.float32, _max_flat_cells=cells)
    got = ts.build_head_block(torch.as_tensor(rows), torch.as_tensor(hp),
                              torch.as_tensor(vals, dtype=torch.float32),
                              320, 37, torch.float32, _max_flat_cells=cells)
    assert got.dtype == want_dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float_values_keep_a_float_head():
    """Non-integer ratings keep the compute dtype (f64 here): products to
    1e-12 relative (their sums are not exact)."""
    rows, cols, vals, dense = _skewed(seed=3, integer=False)
    top = ts.split_coo_operator(rows, cols, vals, dense.shape,
                                head_items=16, event_chunk=128, tile=8,
                                dtype=torch.float64, device="cpu")
    assert top.operands[0][0].dtype == torch.float64
    x, y = _panels(*dense.shape)
    np.testing.assert_allclose(top.mm(torch.as_tensor(x, dtype=torch.float64)
                                      ).numpy(), dense @ x, rtol=1e-12)
    np.testing.assert_allclose(top.rmm(torch.as_tensor(
        y, dtype=torch.float64)).numpy(), dense.T @ y, rtol=1e-12)


def test_head_budget_default_on_the_cpu():
    """None is the JAX package's 2.0 GiB on the CPU; a number is used as
    given."""
    assert ts.resolve_head_budget(None, "cpu") == ts.CPU_HEAD_BUDGET_GB == 2.0
    assert ts.resolve_head_budget(0.5, "cpu") == 0.5
    assert tconfig.get_default("streaming_head_gb") is None
    assert tconfig.get_default("streaming_split_head") is True


@pytest.mark.parametrize("kind", ["chunked", "tiled", "split"])
def test_empty_input_raises(kind):
    empty = np.array([], np.int32)
    with pytest.raises(ValueError, match="empty"):
        getattr(ts, f"{kind}_coo_operator")(empty, empty, empty.astype(float),
                                            (3, 4), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        getattr(ts.CooMatrix.from_numpy(empty, empty, empty.astype(float),
                                        (3, 4), device="cpu"),
                f"{kind}_operator")()


def test_coo_matrix_streaming_methods_equal_dense():
    """``CooMatrix.{chunked,tiled,split}_operator``: the dense products
    (the matrix's entries are already row-sorted on their device)."""
    rows, cols, vals, dense = _skewed()
    tm = ts.CooMatrix.from_numpy(rows, cols, vals, dense.shape,
                                 device="cpu")
    for name, kw in (("chunked_operator", dict(event_chunk=50)),
                     ("tiled_operator", dict(event_chunk=64, tile=8)),
                     ("split_operator", dict(head_items=16, tile=8))):
        _assert_products(None, getattr(tm, name)(**kw), dense,
                         *_panels(*dense.shape))


def test_rsvd_through_streaming_operators_matches_dense():
    """f64 subspace iteration to convergence over each streaming operator
    and over the dense block, one seed: singular values to 1e-9 relative,
    and the column spans (max sin of the principal angles) to 1e-7."""
    from polara_tpu_torch.ops.rsvd import principal_angles_max_sin
    rows, cols, vals, dense = _skewed(m=180, n=120, n_events=5000, seed=7)
    want = tsvd_module.randomized_svd(torch.as_tensor(dense), 8, tol=1e-12,
                                      max_iter=300, seed=5)
    kw = dict(dtype=torch.float64, device="cpu", event_chunk=512)
    for op in (ts.chunked_coo_operator(rows, cols, vals, dense.shape, **kw),
               ts.tiled_coo_operator(rows, cols, vals, dense.shape, tile=8,
                                     **kw),
               ts.split_coo_operator(rows, cols, vals, dense.shape,
                                     head_items=32, tile=8, **kw)):
        got = tsvd_module.randomized_svd(op, 8, tol=1e-12, max_iter=300,
                                         seed=5)
        np.testing.assert_allclose(got.s.numpy(), want.s.numpy(), rtol=1e-9)
        assert principal_angles_max_sin(got.v, want.v) < 1e-7


# ---- routing past the budget ------------------------------------------------

class Routed(Exception):
    """Raised by the spies in place of a build: carries the tier taken."""


def _names(op):
    return {"_dense_mm": "dense", "_sharded_mm": "dense", "_coo_mm": "coo",
            "_split_mm": "split", "_tiled_mm": "tiled"}[op.mm_fn.__name__]


def _spy_routes(monkeypatch):
    """Both packages' single-device SVD and iALS build steps replaced by
    spies that raise :class:`Routed` with the tier the routing took,
    before any staging."""
    def solver(a, *args, **kwargs):
        raise Routed(_names(a) if hasattr(a, "mm_fn") else "dense")

    def tier(name):
        def spy(*args, **kwargs):
            raise Routed(name)
        return spy

    import polara_tpu.models.svd as jsvd_module
    import polara_tpu.models.implicit_mf as jials_module
    import polara_tpu_torch.models.implicit_mf as tials_module
    monkeypatch.setattr(jsvd_module, "randomized_svd", solver)
    monkeypatch.setattr(tsvd_module, "randomized_svd", solver)
    for cls in (js.CooMatrix, ts.CooMatrix):
        monkeypatch.setattr(cls, "split_operator", tier("split"))
        monkeypatch.setattr(cls, "tiled_operator", tier("tiled"))
    monkeypatch.setattr(jials_module, "ials_train", tier("dense"))
    monkeypatch.setattr(tials_module, "ials_train", tier("dense"))
    monkeypatch.setattr(jimplicit, "ials_train_events", tier("events"))
    monkeypatch.setattr(tials_module, "ials_train_events", tier("events"))


def _route(model):
    with pytest.raises(Routed) as caught:
        model.build()
    return str(caught.value)


@pytest.fixture(scope="module")
def sparse_pair():
    """300 x 400 at 3.3% density: the COO panel (nnz x 12 at rank 2) is
    smaller than the dense block, so every tier has a budget of its
    own."""
    frame = tsyn.make_realistic_interactions(n_users=300, n_items=400,
                                             n_events=4000, seed=3)
    out = []
    for cls in (JaxData, TorchData):
        data = cls(frame.copy(), "userid", "movieid", "rating", seed=0,
                   verbose=False)
        data.holdout_size = 1
        data.prepare()
        out.append(data)
    return out


def _budgeted(value, split=True):
    for config in (jconfig, tconfig):
        config.set_default("hbm_score_budget_gb", value)
        config.set_default("streaming_split_head", split)


@pytest.fixture
def restore_budget():
    saved = [(c, c.get_default("hbm_score_budget_gb"),
              c.get_default("streaming_split_head"))
             for c in (jconfig, tconfig)]
    yield
    for config, budget, split in saved:
        config.set_default("hbm_score_budget_gb", budget)
        config.set_default("streaming_split_head", split)


@pytest.mark.parametrize("budget,split,svd_tier,ials_tier", [
    (1e-3, True, "dense", "dense"),
    (3e-4, True, "coo", "events"),
    (1e-5, True, "split", "events"),
    (1e-5, False, "tiled", "events"),
])
def test_single_device_routing_follows_jax(sparse_pair, monkeypatch,
                                           restore_budget, budget, split,
                                           svd_tier, ials_tier):
    """A sweep of ``hbm_score_budget_gb``: the port's ``SVDModel`` and
    ``ImplicitALS`` take the JAX package's tier at every budget."""
    jdata, tdata = sparse_pair
    _spy_routes(monkeypatch)
    _budgeted(budget, split)
    routes = []
    for data, svd, als in ((jdata, JaxSVD, JaxALS),
                           (tdata, TorchSVD, TorchALS)):
        kw = {} if svd is JaxSVD else {"device": "cpu"}
        model = svd(data, **kw)
        model.rank = 2
        routes.append((_route(model), _route(als(data, **kw))))
    assert routes[0] == routes[1] == (svd_tier, ials_tier)


def test_streaming_svd_recommends_like_the_dense_block(sparse_pair,
                                                       restore_budget):
    """f64 builds, 60 power iterations from one seed: the split, tiled and
    COO tiers give the dense block's recommendations, id for id."""
    _, tdata = sparse_pair
    tconfig.set_default("compute_dtype", "float64")
    try:
        recs = {}
        for name, budget, split in (("dense", 1e-3, True),
                                    ("coo", 3e-4, True),
                                    ("split", 1e-5, True),
                                    ("tiled", 1e-5, False)):
            _budgeted(budget, split)
            model = TorchSVD(tdata, device="cpu")
            model.verbose = False
            model.rank = 8
            model.svd_tol, model.svd_iters = None, 60
            model.build()
            recs[name] = np.asarray(model.recommendations)
    finally:
        tconfig.set_default("compute_dtype", "float32")
    for name in ("coo", "split", "tiled"):
        np.testing.assert_array_equal(recs[name], recs["dense"],
                                      err_msg=name)


def test_jax_streaming_results_carry_to_the_port():
    """``result_from_jax``: a JAX rSVD over its chunked streaming operator
    becomes the port's ``SvdResult`` (arrays unchanged), and its item
    factors pick the JAX package's ids through the port's
    ``score_mask_topk_step``; a JAX ``ImplicitFactors`` becomes the
    port's."""
    from polara_tpu import parallel as jpar
    from polara_tpu_torch import parallel as tpar
    rows, cols, vals, dense = _skewed()
    want = jrsvd.randomized_svd(
        js.chunked_coo_operator(rows, cols, vals, dense.shape,
                                event_chunk=37), 6, n_iter=2, seed=0)
    got = result_from_jax(want, device="cpu")
    assert type(got).__name__ == "SvdResult" and got.v.dtype == torch.float32
    for name in ("u", "s", "v"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    seen_r, seen_c = np.nonzero(dense)
    picks = jpar.score_mask_topk_step(
        want.v, jnp.asarray(dense, jnp.float32),
        jnp.asarray(seen_r, jnp.int32), jnp.asarray(seen_c, jnp.int32),
        jnp.ones(len(seen_r), bool), 10)
    port = tpar.score_mask_topk_step(
        got.v, torch.as_tensor(dense, dtype=torch.float32),
        torch.as_tensor(seen_r), torch.as_tensor(seen_c),
        torch.ones(len(seen_r), dtype=torch.bool), 10)
    np.testing.assert_array_equal(port.numpy(), np.asarray(picks))

    factors = jimplicit.ImplicitFactors(user=jnp.asarray(got.u.numpy()),
                                        item=jnp.asarray(got.v.numpy()))
    carried = result_from_jax(factors, device="cpu", dtype=torch.float64)
    assert type(carried) is timplicit.ImplicitFactors
    assert carried.item.dtype == torch.float64
    np.testing.assert_array_equal(carried.user.numpy(), got.u.numpy())
    other = collections.namedtuple("HooiResult", "core")(np.zeros(2))
    with pytest.raises(TypeError, match="no port counterpart"):
        result_from_jax(other, device="cpu")


# ---- generators and runtime helpers ------------------------------------------

def test_numpy_generators_equal_jax():
    """``make_realistic_coo`` and ``make_realistic_interactions`` draw from
    ``RandomState``: arrays and frame equal the JAX package's."""
    kw = dict(n_users=120, n_items=90, n_events=2500, seed=4)
    for got, want in zip(tsyn.make_realistic_coo(**kw),
                         jsyn.make_realistic_coo(**kw)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = tsyn.make_realistic_interactions(**kw)
    want = jsyn.make_realistic_interactions(**kw)
    assert got.equals(want)
    assert tsyn.NETFLIX_GEOMETRY == jsyn.NETFLIX_GEOMETRY


def test_runtime_memory_helpers_equal_jax(tmp_path):
    """``pad_dim``, ``get_chunk_size``, ``array_split`` as the JAX
    package's; ``get_available_memory`` reads host RAM;
    ``read_npz_from_url`` reads a ``file://`` URL."""
    for n, lane in ((1, True), (129, True), (0, False), (13, False)):
        assert truntime.pad_dim(n, lane) == jmem.pad_dim(n, lane)
    for args in ((1000, 500), (70_000, 10_677, 2, 0.5), (7, 3)):
        assert truntime.get_chunk_size(*args) == jmem.get_chunk_size(*args)
        assert truntime.array_split(*args) == jmem.array_split(*args)
    assert truntime.get_available_memory() > 0
    path = tmp_path / "blob.npz"
    np.savez(path, a=np.arange(5), b=np.eye(2))
    with truntime.read_npz_from_url(path.as_uri()) as blob:
        np.testing.assert_array_equal(blob["a"], np.arange(5))
        np.testing.assert_array_equal(blob["b"], np.eye(2))
