"""The port's padded rows, batched inner products and exclusion samplers
against the JAX package's, on the CPU.  Device draws come from different
random streams in the two packages, so samples are held to their
properties, and to the JAX package's where the sample is forced (a row
whose unseen count equals the sample size)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from polara_tpu.ops import samplers as jsamplers
from polara_tpu.ops.sparse import inner_product_at as jax_inner_product_at
from polara_tpu.ops.sparse import pad_rows as jax_pad_rows
from polara_tpu_torch.ops import samplers
from polara_tpu_torch.ops.sparse import inner_product_at, pad_rows
from polara_tpu_torch.runtime.rng import generator_from_seed


def _seen(rs, n_rows, n_cols, density=0.3):
    mask = rs.rand(n_rows, n_cols) < density
    rows, cols = np.nonzero(mask)
    return rows, cols, mask


@pytest.mark.parametrize("with_values,width", [(False, None), (True, None),
                                               (True, 40)])
def test_pad_rows_equals_jax(with_values, width):
    rs = np.random.RandomState(0)
    rows, cols, _ = _seen(rs, 30, 50)
    values = rs.randint(1, 6, len(rows)).astype(np.float32) \
        if with_values else None
    got = pad_rows(rows, cols, values, 33, width)
    want = jax_pad_rows(rows, cols, values, 33, width)
    for name in ("indices", "mask", "values"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got.shape == want.shape


def test_pad_rows_raises_past_width():
    with pytest.raises(ValueError):
        pad_rows(np.array([0, 0, 0]), np.array([1, 2, 3]), None, 1, 2)


def _factors(rs, n, rank, dyadic):
    if dyadic:
        return np.clip(np.round(rs.randn(n, rank) * 4) / 4, -2, 2
                       ).astype(np.float32)
    return rs.randn(n, rank).astype(np.float32)


@pytest.mark.parametrize("dyadic", [True, False])
def test_inner_product_at_equals_jax(dyadic):
    """Exact on dyadic factors; 1e-6 relative to the row's scale on
    Gaussian ones (the rank sums run in different orders)."""
    rs = np.random.RandomState(1)
    u, v = _factors(rs, 20, 8, dyadic), _factors(rs, 90, 8, dyadic)
    ui = rs.randint(0, 20, (20, 15))
    vi = rs.randint(0, 90, (20, 15))
    got = inner_product_at(torch.as_tensor(u), torch.as_tensor(v),
                           torch.as_tensor(ui), torch.as_tensor(vi))
    want = np.asarray(jax_inner_product_at(jnp.asarray(u), jnp.asarray(v),
                                           jnp.asarray(ui), jnp.asarray(vi)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dyadic:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * scale)


def test_inner_product_at_blocks_give_the_same_bits():
    rs = np.random.RandomState(2)
    u = torch.as_tensor(_factors(rs, 40, 12, False))
    v = torch.as_tensor(_factors(rs, 300, 12, False))
    vi = torch.as_tensor(rs.randint(0, 300, (40, 99)))
    ui = torch.arange(40)[:, None]
    whole = inner_product_at(u, v, ui, vi)
    assert whole.shape == (40, 99)
    for block_rows in (1, 7, 39):
        assert torch.equal(inner_product_at(u, v, ui, vi,
                                            block_rows=block_rows), whole)


class TestSampleRowWise:
    def test_excludes_seen_without_replacement(self):
        rs = np.random.RandomState(0)
        rows, cols, mask = _seen(rs, 50, 40, 0.4)
        sampled = samplers.sample_row_wise(rows, cols, 50, 40, 10, seed=1,
                                           chunk_rows=16, device="cpu")
        assert sampled.dtype == np.int32 and sampled.shape == (50, 10)
        assert not mask[np.arange(50)[:, None], sampled].any()
        assert all(len(set(r)) == 10 for r in sampled.tolist())
        again = samplers.sample_row_wise(rows, cols, 50, 40, 10, seed=1,
                                         chunk_rows=16, device="cpu")
        np.testing.assert_array_equal(again, sampled)

    def test_raises_when_infeasible(self):
        with pytest.raises(ValueError):
            samplers.sample_row_wise(np.zeros(8, int), np.arange(8), 1, 10,
                                     5, device="cpu")

    def test_forced_sample_equals_jax(self):
        """Every row has exactly n_samples unseen columns: one possible
        set, which both packages draw."""
        rs = np.random.RandomState(3)
        n_rows, n_cols, k = 25, 30, 7
        mask = np.ones((n_rows, n_cols), bool)
        for r in range(n_rows):
            mask[r, rs.choice(n_cols, k, replace=False)] = False
        rows, cols = np.nonzero(mask)
        order = rs.permutation(len(rows))      # any event order
        got = samplers.sample_row_wise(rows[order], cols[order], n_rows,
                                       n_cols, k, seed=4, chunk_rows=8,
                                       device="cpu")
        want = jsamplers.sample_row_wise(rows, cols, n_rows, n_cols, k,
                                         seed=4)
        np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))

    def test_uniform_chi_square(self):
        """No exclusions: item counts pass a chi-square test of
        uniformity (and stay within 1% of 1/20 as in the JAX test)."""
        sampled = samplers.sample_row_wise(np.array([], int),
                                           np.array([], int), 4000, 20, 5,
                                           seed=3, device="cpu")
        counts = np.bincount(sampled.ravel(), minlength=20)
        assert stats.chisquare(counts).pvalue > 1e-3
        freq = counts / counts.sum()
        assert np.abs(freq - 1 / 20).max() < 0.01


def _scores_case(seed, n_users=12, n_items=30, rank=5, unseen=6):
    rs = np.random.RandomState(seed)
    u = _factors(rs, n_users, rank, True)
    v = _factors(rs, n_items, rank, True)
    mask = np.ones((n_users, n_items), bool)
    for r in range(n_users):
        mask[r, rs.choice(n_items, unseen, replace=False)] = False
    rows, cols = np.nonzero(mask)
    return u, v, rows, cols, mask


@pytest.mark.parametrize("chunk_rows", [None, 5])
def test_sampled_scores_forced_sample_equals_jax(chunk_rows):
    u, v, rows, cols, _ = _scores_case(5)
    got, items = samplers.sampled_scores(
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(rows),
        torch.as_tensor(cols), torch.ones(len(rows), dtype=torch.bool),
        generator_from_seed(0), 6, chunk_rows=chunk_rows,
        return_items=True)
    key = jax.random.key(0)
    args = (jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
            jnp.ones(len(rows), bool))
    want = np.asarray(jsamplers.sampled_scores(
        jnp.asarray(u), jnp.asarray(v), *args, key, 6))
    want_items = np.asarray(jsamplers._sample_excluded(
        key, *args, u.shape[0], v.shape[0], 6))
    assert items.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(items.numpy(), 1),
                                  np.sort(want_items, 1))
    np.testing.assert_array_equal(np.sort(got.numpy(), 1),
                                  np.sort(want, 1))
    # the scores are the sampled items' inner products
    np.testing.assert_array_equal(
        got.numpy(), (u[:, None, :] * v[items.numpy()]).sum(-1))


def test_sampled_scores_properties():
    """Exclusion (invalid pairs excluded nothing), no repeats, blocks
    drawn in turn from one generator: the same seed, the same draw."""
    u, v, rows, cols, mask = _scores_case(6, n_users=40, n_items=50,
                                          unseen=20)
    valid = torch.as_tensor(np.random.RandomState(0).rand(len(rows)) < 0.8)
    runs = [samplers.sampled_scores(
        torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(rows),
        torch.as_tensor(cols), valid, generator_from_seed(9), 15,
        chunk_rows=16, return_items=True) for _ in range(2)]
    (scores, items), (scores2, items2) = runs
    assert torch.equal(scores, scores2) and torch.equal(items, items2)
    seen = np.zeros_like(mask)
    seen[rows[valid.numpy()], cols[valid.numpy()]] = True
    picked = items.numpy()
    assert not seen[np.arange(40)[:, None], picked].any()
    assert all(len(set(r)) == 15 for r in picked.tolist())


@pytest.mark.parametrize("n", [200, 12_000])
def test_split_top_continuous_equals_jax(n):
    """Below and above the 10,000-task native threshold."""
    rs = np.random.RandomState(n)
    tasks = rs.randint(0, n // 8, n)
    priorities = rs.permutation(n).astype(np.float64)
    got = samplers.split_top_continuous(tasks, priorities)
    want = jsamplers.split_top_continuous(tasks, priorities)
    for g, w in zip(got, want):
        assert list(g) == list(w)
