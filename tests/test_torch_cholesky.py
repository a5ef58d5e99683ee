"""The port's dense Cholesky factors and HybridSVD operator
(``ops/cholesky.py``) against ``polara_tpu``'s on the CPU, in f64: the same
numpy inputs through both packages, each tolerance stated with its test."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polara_tpu.ops import cholesky as jc
from polara_tpu.ops.sparse import CooMatrix as JaxCoo
from polara_tpu_torch.ops import cholesky as tc
from polara_tpu_torch.ops.sparse import CooMatrix as TorchCoo

N = 12


def _similarity(n, seed=0):
    rs = np.random.RandomState(seed)
    base = rs.rand(n, 5)
    sim = base @ base.T
    return sim / np.sqrt(np.outer(np.diag(sim), np.diag(sim)))


@pytest.fixture(scope="module")
def factors():
    sim = _similarity(N)
    return (jc.CholeskyFactor.factorize(jnp.asarray(sim), beta=1.0),
            tc.CholeskyFactor.factorize(torch.as_tensor(sim), beta=1.0))


def test_factor_matches_jax(factors):
    """L of S + I within 1e-10 of the JAX package's (f64)."""
    want, got = factors
    np.testing.assert_allclose(got.L.numpy(), np.asarray(want.L), rtol=0,
                               atol=1e-10)
    assert torch.equal(got.L, torch.tril(got.L))


@pytest.mark.parametrize("op", ["dot", "T.dot", "solve", "T.solve"])
@pytest.mark.parametrize("width", [None, 3])
def test_products_and_solves_match_jax(factors, op, width):
    """L v, Lᵀ v, L⁻¹ v and L⁻ᵀ v on a vector and on a 3-wide panel:
    within 1e-10 of the JAX package's (f64)."""
    want, got = factors
    rs = np.random.RandomState(1)
    v = rs.randn(N) if width is None else rs.randn(N, width)
    transposed, method = ("T." in op), op.split(".")[-1]
    jf, tf = (want.T, got.T) if transposed else (want, got)
    expect = np.asarray(getattr(jf, method)(jnp.asarray(v)))
    result = getattr(tf, method)(torch.as_tensor(v)).numpy()
    assert result.shape == expect.shape
    np.testing.assert_allclose(result, expect, rtol=0, atol=1e-10)


def test_update_inplace_matches_jax():
    """Refactorizing at another beta gives the JAX package's factor
    within 1e-10 (f64)."""
    sim = _similarity(N)
    want = jc.CholeskyFactor.factorize(jnp.asarray(sim), beta=1.0)
    got = tc.CholeskyFactor.factorize(torch.as_tensor(sim), beta=1.0)
    want.update_inplace(jnp.asarray(sim), 0.25)
    got.update_inplace(torch.as_tensor(sim), 0.25)
    np.testing.assert_allclose(got.L.numpy(), np.asarray(want.L), rtol=0,
                               atol=1e-10)


def _not_positive_definite():
    sim = _similarity(N)
    sim[0, 1] = sim[1, 0] = 5.0       # |s01| > 1 on a unit diagonal
    return sim


def test_not_positive_definite_raises_in_both_packages():
    """A similarity with S + beta I indefinite raises the same ValueError
    in both packages (the port reads ``cholesky_ex``'s info)."""
    sim = _not_positive_definite()
    with pytest.raises(ValueError, match="Cholesky factorization failed"):
        jc.CholeskyFactor.factorize(jnp.asarray(sim), beta=0.0)
    with pytest.raises(ValueError, match="Cholesky factorization failed"):
        tc.CholeskyFactor.factorize(torch.as_tensor(sim), beta=0.0)


def test_update_inplace_to_an_indefinite_matrix_raises():
    """The JAX package's ``update_inplace`` leaves a NaN factor when
    S + beta I is indefinite (ROADMAP C4); the port raises the
    factorization's ValueError instead."""
    sim = _not_positive_definite()
    want = jc.CholeskyFactor.factorize(jnp.asarray(_similarity(N)), 1.0)
    want.update_inplace(jnp.asarray(sim), 0.0)
    assert np.isnan(np.asarray(want.L)).any()
    got = tc.CholeskyFactor.factorize(torch.as_tensor(_similarity(N)), 1.0)
    with pytest.raises(ValueError, match="Cholesky factorization failed"):
        got.update_inplace(torch.as_tensor(sim), 0.0)


@pytest.fixture(scope="module")
def ratings():
    rs = np.random.RandomState(2)
    r = rs.randint(1, 6, (10, 8)) * (rs.rand(10, 8) < 0.5)
    rows, cols = np.nonzero(r)
    l_user = np.linalg.cholesky(_similarity(10, seed=3) + np.eye(10))
    l_item = np.linalg.cholesky(_similarity(8, seed=4) + np.eye(8))
    return r, rows, cols, l_user, l_item


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("with_user", [False, True])
@pytest.mark.parametrize("with_item", [False, True])
def test_hybrid_operator_matches_jax(ratings, dense, with_user, with_item):
    """``mm`` and ``rmm`` of ``L_uᵀ R L_i`` on both tiers (COO: sorted
    segment sums; dense: the densified block), each factor present or
    None: within 1e-10 of the JAX package's operator and of the explicit
    product (f64)."""
    r, rows, cols, l_user, l_item = ratings
    lu = l_user if with_user else None
    li = l_item if with_item else None
    budget = 1 << 30 if dense else None
    jop = jc.hybrid_operator(
        JaxCoo.from_numpy(rows, cols, r[rows, cols], r.shape,
                          dtype=jnp.float64),
        None if lu is None else jnp.asarray(lu),
        None if li is None else jnp.asarray(li), dense_budget_bytes=budget)
    coo = TorchCoo.from_numpy(rows, cols, r[rows, cols], r.shape,
                              dtype=torch.float64, device="cpu")
    top = tc.hybrid_operator(
        coo.to_dense() if dense else coo,
        None if lu is None else torch.as_tensor(lu),
        None if li is None else torch.as_tensor(li))
    explicit = ((lu.T if lu is not None else np.eye(10)) @ r
                @ (li if li is not None else np.eye(8)))
    rs = np.random.RandomState(5)
    x, y = rs.randn(8, 3), rs.randn(10, 3)
    for method, arg, expect in (("mm", x, explicit @ x),
                                ("rmm", y, explicit.T @ y)):
        got = getattr(top, method)(torch.as_tensor(arg)).numpy()
        want = np.asarray(getattr(jop, method)(jnp.asarray(arg)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-10)


@pytest.mark.parametrize("slack", [0, -1])
def test_budget_routing_takes_the_jax_tier(monkeypatch, slack):
    """At a budget of exactly the ratings block's bytes the JAX package's
    operator densifies and the port's HybridSVD hands the operator its
    dense block; one byte less, both keep the COO tier."""
    from polara_tpu.datasets import make_synthetic_interactions
    from polara_tpu_torch import config as tconfig
    from polara_tpu_torch.data import SimilarityDataModel
    from polara_tpu_torch.models import HybridSVD
    from polara_tpu_torch.models import hybrid as thybrid
    events = make_synthetic_interactions(n_users=30, n_items=N,
                                         n_events=200, seed=0)
    ids = np.sort(events["movieid"].unique())
    data = SimilarityDataModel(
        events, "userid", "movieid", "rating",
        relations_matrices={"movieid": _similarity(len(ids)),
                            "userid": None},
        relations_indices={"movieid": ids, "userid": None},
        seed=0, verbose=False)
    data.prepare()
    model = HybridSVD(data, device="cpu")
    model.verbose, model.rank = False, 3
    coo = model.get_training_matrix()
    budget = coo.shape[0] * coo.shape[1] * coo.vals.element_size() + slack
    jop = jc.hybrid_operator(
        JaxCoo.from_numpy(coo.rows.numpy(), coo.cols.numpy(),
                          coo.vals.numpy(), coo.shape,
                          dtype=jnp.float32), None, None,
        dense_budget_bytes=budget)
    jax_dense = jop.operands[3] is not None
    assert jax_dense == (slack == 0)
    tiers = []

    def spy(ratings, *factors):
        tiers.append(isinstance(ratings, torch.Tensor))
        return tc.hybrid_operator(ratings, *factors)

    monkeypatch.setattr(thybrid, "hybrid_operator", spy)
    saved = tconfig.get_default("hbm_score_budget_gb")
    try:
        tconfig.set_default("hbm_score_budget_gb", budget / 2 ** 30)
        model.build()
    finally:
        tconfig.set_default("hbm_score_budget_gb", saved)
    assert tiers == [jax_dense]
