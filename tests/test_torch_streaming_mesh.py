"""The port's event-sharded streaming tier over a mesh
(``distributed_chunked_rsvd``, ``distributed_ials_events``) against its
single-device counterparts, and the mesh routing of ``SVDModel`` and
``ImplicitALS`` past the memory budget against ``polara_tpu``'s.  The
port's meshes repeat the ``cpu`` device, as in
``tests/test_torch_distributed.py``; the JAX side runs on the 8 virtual
CPU devices of ``tests/conftest.py``."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from polara_tpu import config as jconfig
from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.models import ImplicitALS as JaxALS
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu.runtime.mesh import make_mesh as jax_make_mesh
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.datasets import make_realistic_interactions
from polara_tpu_torch.models import ImplicitALS as TorchALS
from polara_tpu_torch.models import SVDModel as TorchSVD
from polara_tpu_torch.ops.implicit import ials_train_events
from polara_tpu_torch.ops.rsvd import randomized_svd
from polara_tpu_torch.parallel import (distributed_chunked_rsvd,
                                       distributed_ials_events)
from polara_tpu_torch.runtime.mesh import make_mesh


def _mesh(n):
    return make_mesh(devices=["cpu"] * n, shape=(n, 1))


def _max_sin(a, b) -> float:
    """Sine of the largest principal angle between two column spans,
    ``‖(I - QₐQₐᵀ) Q_b‖₂``: accurate to ~1e-15 in f64 (the ``sqrt(1 -
    cos²)`` form bottoms out near 1e-8)."""
    qa, _ = np.linalg.qr(np.asarray(a))
    qb, _ = np.linalg.qr(np.asarray(b))
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


@pytest.fixture(scope="module")
def zipf_events():
    """The JAX split-head test's events: 301 x 83 (divisible by neither
    mesh nor chunk), Zipf item margins, duplicate pairs."""
    rs = np.random.RandomState(7)
    m, n, n_events = 301, 83, 6000
    w = 1.0 / np.arange(1, n + 1) ** 0.9
    cols = rs.choice(n, size=n_events, p=w / w.sum())
    rows = np.sort(rs.randint(0, m, n_events))
    vals = rs.randint(1, 6, n_events).astype(np.float64)
    dense = np.zeros((m, n))
    np.add.at(dense, (rows, cols), vals)
    single = randomized_svd(torch.as_tensor(dense), 7, n_iter=40, seed=0,
                            qr_method="cholesky2")
    return rows, cols, vals, (m, n), single


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("split_head", [False, True])
def test_distributed_chunked_rsvd_matches_single_device(zipf_events, n_dev,
                                                        split_head):
    """f64, 40 iterations from the same start as the single-device
    CholeskyQR2 build over the dense block: singular values to 1e-9
    relative, both factors' spans to max sin < 1e-8.  The split head (24
    items, 16-row blocks) carries duplicate cells; 97-event chunks cut
    rows across chunks."""
    rows, cols, vals, shape, single = zipf_events
    got = distributed_chunked_rsvd(
        rows, cols, vals, shape, 7, _mesh(n_dev), n_iter=40, seed=0,
        event_chunk=97, dtype=torch.float64, split_head=split_head,
        head_items=24, head_block_rows=16)
    assert tuple(got.u.shape) == (shape[0], 7)
    np.testing.assert_allclose(got.s.numpy(), single.s.numpy(), rtol=1e-9)
    assert _max_sin(got.v, single.v) < 1e-8
    assert _max_sin(got.u, single.u) < 1e-8


def test_declined_head_and_tolerance_stop(zipf_events):
    """Flat margins: the head declines below ``min_coverage`` and the
    split call gives the plain banded build's bits; with ``tol`` the build
    stops on the single-device rule and still reaches the dense block's
    singular values."""
    rows, _, vals, shape, single = zipf_events
    flat = np.random.RandomState(1).randint(0, shape[1], len(rows))
    kw = dict(n_iter=5, seed=0, event_chunk=97, dtype=torch.float64)
    declined = distributed_chunked_rsvd(rows, flat, vals, shape, 7,
                                        _mesh(4), split_head=True,
                                        head_items=4, min_coverage=0.9,
                                        **kw)
    plain = distributed_chunked_rsvd(rows, flat, vals, shape, 7, _mesh(4),
                                     **kw)
    for a, b in zip(declined, plain):
        assert torch.equal(a, b)
    rows, cols, vals, shape, single = zipf_events
    stopped = distributed_chunked_rsvd(rows, cols, vals, shape, 7, _mesh(4),
                                       tol=1e-12, max_iter=200, seed=0,
                                       dtype=torch.float64)
    np.testing.assert_allclose(stopped.s.numpy(), single.s.numpy(),
                               rtol=1e-9)


def _coo(m, n, density, seed):
    rs = np.random.RandomState(seed)
    return sp.random(m, n, density=density, random_state=rs,
                     data_rvs=lambda s: rs.randint(1, 6, s).astype(float)
                     ).tocoo()


@pytest.mark.parametrize("m,n,density,seed,rank,tile,be,n_dev", [
    (97, 53, 0.2, 7, 5, 8, 16, 8),     # the JAX test's case
    (200, 40, 0.15, 11, 4, 8, 7, 8),   # bands of several entity batches
    (61, 37, 0.25, 2, 6, 4, 5, 4),
])
def test_distributed_ials_events_matches_single_device(m, n, density, seed,
                                                       rank, tile, be,
                                                       n_dev):
    """f64, 3 epochs from the same start: user and item factors within
    rtol 1e-5 of ``ials_train_events`` (the tolerance of the port's
    ``distributed_ials`` test); the stats name the mode and the bytes."""
    coo = _coo(m, n, density, seed)
    stats = {}
    kw = dict(rank=rank, num_epochs=3, seed=0, tile=tile,
              batch_entities=be, dtype=torch.float64)
    dist = distributed_ials_events(coo.row, coo.col, coo.data, coo.shape,
                                   mesh=_mesh(n_dev), train_stats=stats,
                                   **kw)
    single = ials_train_events(coo.row, coo.col, coo.data, coo.shape,
                               device="cpu", **kw)
    assert tuple(dist.user.shape) == (m, rank)
    for a, b in ((dist.user, single.user), (dist.item, single.item)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-12)
    assert stats["mode"] == "sharded-event-streams"
    assert len(stats["epochs"]) == 3 and stats["epochs"][0]["comm_bytes"] > 0


def test_distributed_ials_events_empty_bands():
    """Fewer items than shards: item bands without events run on the
    zero-weight placeholder; a user without events stays zero."""
    rows = np.array([5, 1, 5, 3, 1, 5, 21, 14], np.int32)
    cols = np.array([0, 2, 1, 2, 0, 3, 4, 1], np.int32)
    vals = np.array([3.0, 4.0, 5.0, 1.0, 2.0, 4.0, 2.0, 5.0])
    kw = dict(rank=3, num_epochs=3, seed=1, tile=4, batch_entities=3,
              dtype=torch.float64)
    dist = distributed_ials_events(rows, cols, vals, (23, 5),
                                   mesh=_mesh(8), **kw)
    single = ials_train_events(rows, cols, vals, (23, 5), device="cpu",
                               **kw)
    for a, b in ((dist.user, single.user), (dist.item, single.item)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-12)
    assert float(dist.user[0].abs().max()) == 0.0


# ---- the models under a mesh past the budget ---------------------------------

@pytest.fixture(scope="module")
def pair():
    frame = make_realistic_interactions(n_users=300, n_items=400,
                                        n_events=4000, seed=3)
    out = []
    for cls in (JaxData, TorchData):
        data = cls(frame.copy(), "userid", "movieid", "rating", seed=0,
                   verbose=False)
        data.holdout_size = 1
        data.prepare()
        out.append(data)
    return out


@pytest.fixture
def budget():
    saved = [(c, c.get_default("hbm_score_budget_gb")) for c in
             (jconfig, tconfig)]
    yield
    for config, value in saved:
        config.set_default("hbm_score_budget_gb", value)


class Routed(Exception):
    pass


@pytest.mark.parametrize("port_budget,tiers", [
    (1e-3, ("dense", "mesh_dense")),
    (3e-4, ("coo", "mesh_events")),
    (1e-5, ("mesh_stream", "mesh_events")),
])
def test_mesh_routing_follows_jax(pair, monkeypatch, budget, port_budget,
                                  tiers):
    """An (8, 1) mesh: the JAX package scales the budget by its 8 devices,
    the port by the distinct devices of its shards (1 for eight ``cpu``
    entries), so the JAX side runs at an eighth of the port's budget; at
    each budget both take the same SVD and iALS tier."""
    import polara_tpu.models.svd as jsvd_module
    import polara_tpu.parallel.distributed as jdist
    import polara_tpu_torch.models.svd as tsvd_module
    import polara_tpu_torch.parallel.distributed as tdist

    def solver(a, *args, **kwargs):
        raise Routed({"_dense_mm": "dense", "_sharded_mm": "dense",
                      "_coo_mm": "coo"}[a.mm_fn.__name__])

    def tier(name):
        def spy(*args, **kwargs):
            raise Routed(name)
        return spy

    monkeypatch.setattr(jsvd_module, "randomized_svd", solver)
    monkeypatch.setattr(tsvd_module, "randomized_svd", solver)
    for module in (jdist, tsvd_module):
        monkeypatch.setattr(module, "distributed_chunked_rsvd",
                            tier("mesh_stream"))
    for module in (jdist, tdist):
        monkeypatch.setattr(module, "distributed_ials_events",
                            tier("mesh_events"))
        monkeypatch.setattr(module, "distributed_ials", tier("mesh_dense"))
    jdata, tdata = pair
    jconfig.set_default("hbm_score_budget_gb", port_budget / 8)
    tconfig.set_default("hbm_score_budget_gb", port_budget)
    jmesh = jax_make_mesh(axes=("users", "model"), shape=(8, 1))
    routes = []
    for data, svd, als, mesh, kw in (
            (jdata, JaxSVD, JaxALS, jmesh, {}),
            (tdata, TorchSVD, TorchALS, _mesh(8), {"device": "cpu"})):
        taken = []
        for cls in (svd, als):
            model = cls(data, **kw)
            model.rank = 2
            model.mesh = mesh
            with pytest.raises(Routed) as caught:
                model.build()
            taken.append(str(caught.value))
        routes.append(tuple(taken))
    assert routes[0] == routes[1] == tiers


def test_models_under_a_mesh_past_the_budget(pair, budget):
    """Past the budget on a (4, 1) mesh, ``SVDModel`` builds with
    ``distributed_chunked_rsvd`` (split head) and ``ImplicitALS`` with
    ``distributed_ials_events``: the factors match the single-device
    streaming builds (singular values 1e-5 relative, spans max sin < 1e-4
    in f32; iALS factors within 1e-4 of their largest entry), and both
    recommend."""
    _, tdata = pair
    tconfig.set_default("hbm_score_budget_gb", 1e-5)
    built = {}
    for name, mesh in (("single", None), ("mesh", _mesh(4))):
        svd = TorchSVD(tdata, device="cpu")
        als = TorchALS(tdata, device="cpu")
        for model in (svd, als):
            model.verbose = False
            model.mesh = mesh
        svd.rank, svd.svd_tol, svd.svd_iters = 6, None, 30
        als.rank, als.num_epochs = 4, 3
        svd.build()
        als.build()
        built[name] = (svd, als)
    (svd1, als1), (svd4, als4) = built["single"], built["mesh"]
    np.testing.assert_allclose(svd4.factors["singular_values"].numpy(),
                               svd1.factors["singular_values"].numpy(),
                               rtol=1e-5)
    assert _max_sin(svd4.factors["movieid"], svd1.factors["movieid"]) < 1e-4
    for field in ("userid", "movieid"):
        want = als1.factors[field]
        assert ((als4.factors[field] - want).abs()
                <= 1e-4 * want.abs().max()).all(), field
    assert svd4.recommendations.shape == svd1.recommendations.shape
    assert als4.recommendations.shape == als1.recommendations.shape
