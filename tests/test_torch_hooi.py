"""The port's HOOI (``polara_tpu_torch.ops.hooi``) and its mesh trainer
(``distributed_hooi``) against ``polara_tpu.ops.hooi`` on the CPU.

The same numpy events go to both packages; HOOI runs from the same start
(the JAX package's own seeded ``u1``, ``u2``, passed as numpy), in f64.
Factors are defined up to column signs, so they are compared by the sine
of their largest principal angle (computed from the projection residual,
which resolves angles far below 1e-8), the core by its norm and by the
Tucker reconstruction at sampled entries.  Each tolerance is stated with
its test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polara_tpu.ops import hooi as jh
from polara_tpu_torch.ops import hooi as th
from polara_tpu_torch.ops import sparse as tsparse
from polara_tpu_torch.parallel import distributed_hooi
from polara_tpu_torch.runtime.mesh import make_mesh

SHAPE, CORE = (40, 25, 4), (6, 5, 2)


def _events(seed=0, n=2000, shape=SHAPE):
    rs = np.random.RandomState(seed)
    idx = np.unique(np.stack([rs.randint(0, s, n) for s in shape], 1),
                    axis=0)
    return idx, rs.randint(1, 4, len(idx)).astype(np.float64)


def _jax_start(shape=SHAPE, core=CORE, seed=0):
    """The JAX package's seeded start (``polara_tpu/ops/hooi.py:130-133``)
    as numpy."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    u1 = jnp.linalg.qr(jax.random.uniform(k1, (shape[1], core[1]),
                                          jnp.float64))[0]
    u2 = jnp.linalg.qr(jax.random.uniform(k2, (shape[2], core[2]),
                                          jnp.float64))[0]
    return np.asarray(u1), np.asarray(u2)


def max_sin(a, b) -> float:
    """Sine of the largest principal angle between the column spans."""
    qa = np.linalg.qr(np.asarray(a, np.float64))[0]
    qb = np.linalg.qr(np.asarray(b, np.float64))[0]
    return float(np.linalg.norm(qb - qa @ (qa.T @ qb), 2))


def _reconstruct(res, entries):
    core, u0, u1, u2 = (np.asarray(x) for x in
                        (res.core, res.u0, res.u1, res.u2))
    i, j, k = entries.T
    return np.einsum("abc,ea,eb,ec->e", core, u0[i], u1[j], u2[k])


@pytest.mark.parametrize("side", [0, 1])
def test_entity_feedback_sums_are_exact(side):
    """Dyadic values and integral factor rows: every sum is exact in both
    packages, so the (entity, level, rank) blocks are equal bit for bit."""
    idx, _ = _events(seed=3)
    rs = np.random.RandomState(4)
    vals = rs.randint(-8, 9, len(idx)) / 4.0
    entity, other = (0, 1) if side == 0 else (1, 0)
    factor = rs.randint(-5, 6, (SHAPE[other], 7)).astype(np.float64)
    want = jh._entity_feedback_sums(
        jnp.asarray(idx[:, entity]), jnp.asarray(idx[:, 2]),
        jnp.asarray(vals), jnp.asarray(factor)[idx[:, other]],
        SHAPE[entity], SHAPE[2])
    t = [torch.as_tensor(idx[:, d]) for d in range(3)]
    events = th.stage_entity_events(t[entity], t[2], t[other],
                                    torch.as_tensor(vals), SHAPE[entity],
                                    SHAPE[2])
    got = th._entity_feedback_sums(events, torch.as_tensor(factor),
                                   SHAPE[2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,rank", [(0, 3), (1, 2), (2, 2), (1, 4)])
def test_round_core_is_bit_identical(mode, rank):
    core = np.random.RandomState(mode).randn(3, 4, 2)
    for want, got in zip(jh.round_core(core, mode, rank),
                         th.round_core(core, mode, rank)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flattener", [
    None, "mean", 2, [0, 3], slice(1, None), (slice(1, 4), "sum"),
    (None, "max"), lambda wt: wt[:, -1]], ids=[
    "none", "str", "int", "list", "slice", "tuple", "tuple-none",
    "callable"])
def test_flatten_feedback_weights_is_bit_identical(flattener):
    w = np.random.RandomState(0).randn(5, 3)
    np.testing.assert_array_equal(
        th.flatten_feedback_weights(w, flattener),
        jh.flatten_feedback_weights(w, flattener))


@pytest.fixture(scope="module")
def reference_runs():
    """JAX HOOI in f64 from its own seeded start: the event tier and the
    dense tier, 8 sweeps (the tolerance 1e-12 is not reached)."""
    idx, val = _events()
    start = _jax_start()
    runs = {}
    for tier, kw in (("events", {}),
                     ("dense", {"dense_budget_bytes": 2 ** 30})):
        runs[tier] = jh.hooi(idx, val, SHAPE, CORE, num_iters=8,
                             growth_tol=1e-12, dtype=jnp.float64,
                             init_factors=start, **kw)
    return idx, val, start, runs


@pytest.mark.parametrize("tier", ["events", "dense"])
def test_hooi_matches_jax(reference_runs, tier):
    """Same start, f64: growth histories within 1e-10 relative, principal
    angles < 1e-8, core norm within 1e-10 relative, the Tucker
    reconstruction at 100 sampled entries within 1e-9."""
    idx, val, start, runs = reference_runs
    want = runs[tier]
    kw = {"dense_budget_bytes": 2 ** 30} if tier == "dense" else {}
    got = th.hooi(idx, val, SHAPE, CORE, num_iters=8, growth_tol=1e-12,
                  dtype=torch.float64, init_factors=start, device="cpu",
                  **kw)
    assert len(got.growth_history) == len(want.growth_history) == 8
    np.testing.assert_allclose(got.growth_history, want.growth_history,
                               rtol=1e-10)
    for a, b in zip((got.u0, got.u1, got.u2), (want.u0, want.u1, want.u2)):
        assert max_sin(a, b) < 1e-8
    np.testing.assert_allclose(torch.linalg.norm(got.core).item(),
                               np.linalg.norm(np.asarray(want.core)),
                               rtol=1e-10)
    entries = np.stack([np.random.RandomState(5).randint(0, s, 100)
                        for s in SHAPE], 1)
    np.testing.assert_allclose(_reconstruct(got, entries),
                               _reconstruct(want, entries), rtol=0,
                               atol=1e-9)


def test_hooi_tiers_agree_from_the_seeded_start():
    """The port's own seeded start, both tiers, 6 sweeps in f64: principal
    angles < 1e-10 (the same math in another summation order); the
    ``tucker_als`` alias runs the same solver."""
    idx, val = _events(seed=1)
    runs = [th.hooi(idx, val, SHAPE, CORE, num_iters=6, growth_tol=0.0,
                    seed=3, dtype=torch.float64, device="cpu", **kw)
            for kw in ({}, {"dense_budget_bytes": 2 ** 30})]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert max_sin(a, b) < 1e-10
    alias = th.tucker_als(idx, val, SHAPE, CORE, num_iters=6,
                          growth_tol=0.0, seed=3, dtype=torch.float64,
                          device="cpu")
    assert torch.equal(alias.core, runs[0].core)
    assert alias.growth_history[0] == 1.0


def test_hooi_verbose_prints_each_sweep(capsys):
    idx, val = _events(seed=1)
    res = th.hooi(idx, val, SHAPE, CORE, num_iters=3, growth_tol=0.0,
                  seed=0, dtype=torch.float64, device="cpu", verbose=True)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == [
        "HOOI step 1", "HOOI step 2", "HOOI step 3"]
    assert len(res.growth_history) == 3


def test_hooi_cholesky_qr_matches_householder():
    """``qr_method="cholesky2"`` (CholeskyQR2 with 1e-6 relative jitter)
    against Householder from one start, f64: principal angles < 1e-6."""
    idx, val = _events(seed=2)
    runs = [th.hooi(idx, val, SHAPE, CORE, num_iters=5, growth_tol=0.0,
                    seed=0, dtype=torch.float64, device="cpu",
                    qr_method=method)
            for method in ("householder", "cholesky2")]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert max_sin(a, b) < 1e-6


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_hooi_shape_errors(package):
    idx, val = _events()
    kw = {} if package == "jax" else {"device": "cpu"}
    run = jh.hooi if package == "jax" else th.hooi
    with pytest.raises(ValueError, match="core shape"):
        run(idx, val, SHAPE, (6, 30, 2), **kw)
    with pytest.raises(ValueError, match="init factors"):
        run(idx, val, SHAPE, CORE, init_factors=(np.zeros((25, 4)),
                                                 np.zeros((4, 2))), **kw)


def test_distributed_hooi_matches_hooi():
    """(4, 1) CPU mesh against one device from the same start, f64, with
    an event count that pads (nnz not a multiple of 4): principal angles
    < 1e-6 (the JAX test's bar, ``tests/test_parallel.py``) and the same
    number of sweeps."""
    idx, val = _events(seed=6, n=1999)
    if len(idx) % 4 == 0:
        idx, val = idx[:-1], val[:-1]
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    dist = distributed_hooi(idx, val, SHAPE, CORE, mesh, num_iters=6,
                            growth_tol=1e-12, seed=0, dtype=torch.float64)
    single = th.hooi(idx, val, SHAPE, CORE, num_iters=6, growth_tol=1e-12,
                     seed=0, dtype=torch.float64, device="cpu")
    assert len(dist.growth_history) == len(single.growth_history) == 6
    for a, b in zip(dist[:3], single[:3]):
        assert max_sin(a, b) < 1e-6
    np.testing.assert_allclose(torch.linalg.norm(dist.core).item(),
                               torch.linalg.norm(single.core).item(),
                               rtol=1e-10)


def test_distributed_hooi_rejects_bad_start_shapes():
    idx, val = _events()
    mesh = make_mesh(devices=["cpu"] * 4, shape=(4, 1))
    with pytest.raises(ValueError, match="init factors"):
        distributed_hooi(idx, val, SHAPE, CORE, mesh,
                         init_factors=(np.zeros((25, 4)), np.zeros((4, 2))))


@pytest.mark.parametrize("block_cells", [1000, 3999])
def test_dense_from_coo_blocks_give_the_same_bits(monkeypatch, block_cells):
    """Past ``DENSE_BLOCK_CELLS`` the host accumulation runs in leading-
    dimension blocks (here 40 x 25 x 4 = 4,000 cells in blocks of 10 and
    of 39 users against one pass): equal bit for bit, f32 and f64, with
    repeated events summed."""
    rs = np.random.RandomState(7)
    idx = np.stack([rs.randint(0, s, 3000) for s in SHAPE], 1)
    val = rs.randn(3000)
    want = {dtype: tsparse.dense_from_coo(idx, val, SHAPE, dtype=dtype,
                                          device="cpu")
            for dtype in (torch.float32, torch.float64)}
    monkeypatch.setattr(tsparse, "DENSE_BLOCK_CELLS", block_cells)
    for dtype, dense in want.items():
        got = tsparse.dense_from_coo(idx, val, SHAPE, dtype=dtype,
                                     device="cpu")
        assert got.dtype == dtype
        assert torch.equal(got, dense)
