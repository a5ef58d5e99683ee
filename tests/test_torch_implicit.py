"""The implicit-feedback ops of the port (``ops/implicit.py``, the fold-ins
of ``models/implicit_mf.py``, ``gather_padded_panels``) against
``polara_tpu``'s on the CPU: the same numpy inputs through both packages,
each tolerance stated with its test."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polara_tpu.models.implicit_mf import _lstsq_fold_in as jax_lstsq
from polara_tpu.ops import implicit as ji
from polara_tpu.ops.sparse import gather_padded_panels as jax_gather
from polara_tpu_torch.models.implicit_mf import _lstsq_fold_in as torch_lstsq
from polara_tpu_torch.ops import implicit as ti
from polara_tpu_torch.ops.sparse import gather_padded_panels

N_USERS, N_ITEMS, RANK = 60, 40, 6


def _close(got, want, rtol):
    """``got`` within ``rtol`` of ``want``, relative to each element or to
    the largest magnitude of ``want``, whichever is larger (solves in f32
    with other summation orders)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def dense():
    rs = np.random.RandomState(0)
    return ((rs.rand(N_USERS, N_ITEMS) < 0.3)
            * rs.randint(1, 6, (N_USERS, N_ITEMS))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_start():
    """The JAX package's iALS starting point (``ials_train``'s draw)."""
    key = jax.random.key(0)
    return np.array(jax.random.normal(key, (N_ITEMS, RANK), jnp.float32)
                    * (1.0 / math.sqrt(RANK)))


@pytest.mark.parametrize("weight", ["log2", "log", "linear", "sqrt", None,
                                    np.log2, np.log, np.sqrt])
def test_confidence_matches_jax_in_f64(weight):
    """Every named weight and the numpy callables, in f64: within 1 ulp
    (XLA's f64 log2 and torch's f64 sqrt are not correctly rounded, so
    those two may differ in the last bit; the others are identical)."""
    rs = np.random.RandomState(1)
    values = rs.randint(0, 6, (20, 15)).astype(np.float64) \
        * rs.rand(20, 15)
    want = np.asarray(ji.confidence(jnp.asarray(values), 2.0, weight, 1.5))
    got = ti.confidence(torch.as_tensor(values), 2.0, weight, 1.5).numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert (got[values == 0] == 0).all()


def test_named_log2_is_not_the_np_log2_callable():
    """The named ``"log2"`` computes log2(x + 1), the callable ``np.log2``
    computes log2(x): the two differ in both packages, by the same
    amounts (f64)."""
    values = np.array([0.0, 1.0, 2.0, 4.0])
    for conf, wrap in ((ji.confidence, jnp.asarray),
                       (ti.confidence, torch.as_tensor)):
        named = np.asarray(conf(wrap(values), 1.0, "log2", 1.0))
        ufunc = np.asarray(conf(wrap(values), 1.0, np.log2, 1.0))
        np.testing.assert_allclose(named, [0.0, 1.0, np.log2(3), np.log2(5)],
                                   rtol=1e-15)
        np.testing.assert_allclose(ufunc, [0.0, 0.0, 1.0, 2.0], rtol=1e-15)


def test_canonical_weight_maps_only_sqrt():
    assert ti.canonical_weight(np.sqrt) == "sqrt"
    assert ti.canonical_weight(torch.sqrt) == "sqrt"
    assert ti.canonical_weight(np.log2) is np.log2
    assert ti.canonical_weight("log") == "log"
    with pytest.raises(ValueError, match="Unknown confidence weight"):
        ti.confidence(torch.ones(3), weight="cube")


def test_half_sweep_matches_jax(dense):
    """One half-sweep over a clamped batch plan (16 rows per batch over 60):
    rtol 1e-4."""
    cm1 = np.array(ji.confidence(jnp.asarray(dense)))
    y = np.random.RandomState(2).randn(N_ITEMS, RANK).astype(np.float32)
    want = ji.ials_half_sweep(jnp.asarray(cm1), jnp.asarray(y), 0.1,
                              batch_rows=16)
    got = ti.ials_half_sweep(torch.as_tensor(cm1), torch.as_tensor(y), 0.1,
                             batch_rows=16)
    _close(got, want, 1e-4)


def test_not_positive_definite_raises(dense):
    """A system that is not positive definite raises; there is no
    fallback."""
    cm1 = ti.confidence(torch.as_tensor(dense))
    y = torch.as_tensor(np.random.RandomState(3).randn(N_ITEMS, RANK),
                        dtype=torch.float32)
    with pytest.raises(torch.linalg.LinAlgError, match="positive definite"):
        ti.ials_half_sweep(cm1, y, -1e4, batch_rows=16)


@pytest.mark.parametrize("weight", ["log2", np.log])
def test_epochs_from_the_jax_start_match_jax(dense, jax_start, weight):
    """Three alternating epochs from the JAX package's starting point, with
    a named and a callable weight: user and item factors within rtol
    1e-4."""
    u0 = np.zeros((N_USERS, RANK), np.float32)
    want = ji._ials_epochs(jnp.asarray(dense), jnp.asarray(u0),
                           jnp.asarray(jax_start), 1.0, 1.0, 0.01,
                           ji.canonical_weight(weight), 3, 16, 8) \
        if isinstance(weight, str) else _jax_margin_epochs(dense, u0,
                                                           jax_start, weight)
    got = ti._ials_epochs(torch.as_tensor(dense), torch.as_tensor(u0),
                          torch.as_tensor(jax_start), 1.0, 1.0, 0.01, weight,
                          3, 16, 8)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def _jax_margin_epochs(dense, u0, start, weight):
    """The JAX package's route for a callable weight (``ials_train``):
    the margin is made first, then the epochs run on it."""
    margin = ji.confidence(jnp.asarray(dense), 1.0, weight, 1.0)
    return ji._ials_epochs(margin, jnp.asarray(u0), jnp.asarray(start), 1.0,
                           1.0, 0.01, "__margin__", 3, 16, 8)


def test_gather_padded_panels_matches_jax():
    """The tile-padded panels of an entity-sorted stream with empty
    entities and partial tiles: identical to the JAX package's."""
    rs = np.random.RandomState(4)
    counts = np.array([3, 0, 9, 1, 0, 4])
    tile = 4
    tiles = -(-counts // tile)
    minor = rs.randint(0, 50, counts.sum())
    vals = rs.rand(counts.sum()).astype(np.float32)
    owner = np.repeat(np.arange(len(counts)), tiles)
    base = np.cumsum(tiles * tile) - tiles * tile
    ev_start = np.cumsum(counts) - counts
    args = (owner, base, counts, ev_start, minor, vals)
    want = jax_gather(*map(jnp.asarray, args), int(tiles.sum()), tile)
    got = gather_padded_panels(*map(torch.as_tensor, args), int(tiles.sum()),
                               tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_event_staging_plan_matches_jax(dense):
    """The host batch plan and the window owner table of one staged side
    (tile 8, 16 entities or 200 events per batch): identical to the JAX
    package's."""
    rows, cols = np.nonzero(dense)
    cm1 = dense[rows, cols]
    kw = dict(tile=8, batch_entities=16, max_window_events=200)
    want = ji.stage_events_side(jnp.asarray(rows), jnp.asarray(cols),
                                jnp.asarray(cm1), N_USERS, **kw)
    got = ti.stage_events_side(torch.as_tensor(rows), torch.as_tensor(cols),
                               torch.as_tensor(cm1), N_USERS, **kw)
    for name in ("minor", "w", "starts", "ent_starts", "n_ents",
                 "owner_local"):
        g = getattr(got, name)
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.batch_entities, got.n_entities) == (want.batch_entities,
                                                    want.n_entities)


def test_ell_half_sweep_matches_jax(dense):
    """One streaming half-sweep over a multi-batch staged side: rtol 1e-4
    against the JAX package's."""
    rows, cols = np.nonzero(dense)
    cm1 = np.array(ji.confidence(jnp.asarray(dense[rows, cols])))
    y = np.random.RandomState(5).randn(N_ITEMS, RANK).astype(np.float32)
    kw = dict(tile=8, batch_entities=16, max_window_events=200)
    jside = ji.stage_events_side(jnp.asarray(rows), jnp.asarray(cols),
                                 jnp.asarray(cm1), N_USERS, **kw)
    tside = ti.stage_events_side(torch.as_tensor(rows),
                                 torch.as_tensor(cols),
                                 torch.as_tensor(cm1), N_USERS, **kw)
    assert len(tside.starts) > 1
    want = ji._ell_half_sweep(
        jside.minor, jside.w, jside.starts, jside.ent_starts, jside.n_ents,
        jside.owner_local, jnp.asarray(y), jnp.float32(0.01),
        n_entities=jside.n_entities, batch_entities=jside.batch_entities,
        tile=jside.tile)
    got = ti._ell_half_sweep(
        tside.minor, tside.w, tside.starts, tside.ent_starts, tside.n_ents,
        tside.owner_local, torch.as_tensor(y), 0.01,
        n_entities=tside.n_entities, batch_entities=tside.batch_entities,
        tile=tside.tile)
    _close(got, want, 1e-4)


EVENT_KW = dict(num_epochs=3, tile=8, batch_entities=16,
                max_window_events=200)


@pytest.fixture(scope="module")
def event_stream(dense):
    """The ratings as an unsorted event stream (the tier sorts it)."""
    rows, cols = np.nonzero(dense)
    order = np.random.RandomState(6).permutation(len(rows))
    return rows[order], cols[order], dense[rows, cols][order]


def test_ials_train_events_from_the_jax_start_matches_jax(
        dense, event_stream, jax_start, monkeypatch):
    """The event tier of both packages from the JAX package's start (the
    port's draw replaced by it), three epochs over multi-batch sides:
    rtol 1e-4."""
    want = ji.ials_train_events(*event_stream, dense.shape, RANK, **EVENT_KW)
    monkeypatch.setattr(ti, "_initial_item_factors",
                        lambda *args: torch.as_tensor(jax_start))
    got = ti.ials_train_events(*event_stream, dense.shape, RANK,
                               device="cpu", **EVENT_KW)
    _close(got.user, want.user, 1e-4)
    _close(got.item, want.item, 1e-4)


def test_event_tier_equals_dense_tier(dense, event_stream):
    """The port's two tiers draw the same start and sweep in the same
    order: they agree to the order of float sums (rtol 1e-4)."""
    events = ti.ials_train_events(*event_stream, dense.shape, RANK,
                                  device="cpu", **EVENT_KW)
    full = ti.ials_train(torch.as_tensor(dense), RANK, num_epochs=3)
    _close(events.user, full.user.numpy(), 1e-4)
    _close(events.item, full.item.numpy(), 1e-4)


def test_ials_fold_in_matches_jax(dense):
    """Warm-start users folded in against fixed item factors: rtol
    1e-4."""
    y = np.random.RandomState(7).randn(N_ITEMS, RANK).astype(np.float32)
    want = ji.ials_fold_in(jnp.asarray(dense[:12]), jnp.asarray(y))
    got = ti.ials_fold_in(torch.as_tensor(dense[:12]), torch.as_tensor(y))
    _close(got, want, 1e-4)


def test_lstsq_fold_in_matches_jax(dense):
    """BPR's ridge fold-in over each user's seen set: rtol 1e-4."""
    y = np.random.RandomState(8).randn(N_ITEMS, RANK).astype(np.float32)
    want = jax_lstsq(jnp.asarray(dense[:12]), jnp.asarray(y), 0.01)
    got = torch_lstsq(torch.as_tensor(dense[:12]), torch.as_tensor(y), 0.01)
    _close(got, want, 1e-4)


def test_bpr_train_end_auc_matches_jax(dense):
    """Different random streams: the last epoch's batch AUC, averaged over
    three seeds, within 0.03 of the JAX package's (one seed spreads by
    ~0.01 at this size), and the history has one entry per epoch."""
    rows, cols = np.nonzero(dense)
    kw = dict(rank=RANK, learning_rate=0.05, num_epochs=15, batch_size=64)
    aucs = {"jax": [], "torch": []}
    for seed in (0, 1, 2):
        stats = []
        ji.bpr_train(rows, cols, dense.shape, seed=seed, epoch_stats=stats,
                     **kw)
        aucs["jax"].append(stats[-1])
        stats = []
        ti.bpr_train(rows, cols, dense.shape, seed=seed, epoch_stats=stats,
                     device="cpu", **kw)
        assert len(stats) == 15
        aucs["torch"].append(stats[-1])
    want, got = np.mean(aucs["jax"]), np.mean(aucs["torch"])
    assert abs(got - want) <= 0.03, aucs
