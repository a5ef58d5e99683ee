"""Unfused masking + top-k of the port (``polara_tpu_torch.ops.topk``)
against the JAX package (``polara_tpu.ops.topk``) on the same numpy
inputs.  Both sides see f32 scores and run the same IEEE arithmetic, so
ids must match exactly, ties included."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polara_tpu.ops import topk as jtopk
from polara_tpu_torch.ops import topk as ttopk


def _seen(rs, n_rows, n_cols, nnz, width):
    """Unique (row, col) seen pairs padded to ``width`` with (0, 0)."""
    flat = rs.choice(n_rows * n_cols, size=nnz, replace=False)
    rows = np.zeros(width, np.int32)
    cols = np.zeros(width, np.int32)
    valid = np.zeros(width, bool)
    rows[:nnz], cols[:nnz], valid[:nnz] = flat // n_cols, flat % n_cols, True
    return rows, cols, valid


def _both(scores, rows, cols, valid, k, filter_seen=True, n_valid=None):
    got = ttopk.mask_and_topk(torch.as_tensor(scores), torch.as_tensor(rows),
                              torch.as_tensor(cols), torch.as_tensor(valid),
                              k, filter_seen=filter_seen,
                              n_valid_cols=n_valid)
    want = jtopk.mask_and_topk(jnp.asarray(scores), jnp.asarray(rows),
                               jnp.asarray(cols), jnp.asarray(valid), k,
                               filter_seen=filter_seen, n_valid_cols=n_valid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,k,filter_seen", [(0, 10, True), (1, 5, False),
                                                (2, 1, True)])
def test_mask_and_topk_random(seed, k, filter_seen):
    rs = np.random.RandomState(seed)
    scores = rs.randn(20, 60).astype(np.float32)
    rows, cols, valid = _seen(rs, 20, 60, 150, 200)
    _both(scores, rows, cols, valid, k, filter_seen=filter_seen)


def test_mask_and_topk_integer_ties():
    rs = np.random.RandomState(3)
    scores = rs.randint(0, 4, (16, 50)).astype(np.float32)
    rows, cols, valid = _seen(rs, 16, 50, 100, 120)
    _both(scores, rows, cols, valid, 12)


def test_pad_beyond_valid_catalog():
    """k > n_valid_cols: the tail is PAD_CONST, padded columns excluded."""
    rs = np.random.RandomState(4)
    scores = rs.randn(8, 40).astype(np.float32)
    rows, cols, valid = _seen(rs, 8, 30, 20, 24)
    _both(scores, rows, cols, valid, 35, n_valid=30)
    got = ttopk.top_k_indices(torch.as_tensor(scores), 35, n_valid_cols=30)
    assert (got[:, 30:] == ttopk.PAD_CONST).all()


def test_k_beyond_unseen_keeps_shift_formula_order():
    """Most items seen: the tail of each list is seen items in the order
    of the reference's block-global shift formula."""
    rs = np.random.RandomState(5)
    scores = (rs.randn(10, 30) * 3).astype(np.float32)
    rows, cols, valid = _seen(rs, 10, 30, 250, 260)
    _both(scores, rows, cols, valid, 20)
