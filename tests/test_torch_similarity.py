"""Similarity functions of the port against ``polara_tpu.ops.similarity``
on the same numpy features, to 1e-6 (both f32 or both f64 per function;
the bound covers summation order)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from polara_tpu.ops import similarity as jsim
from polara_tpu_torch.ops import similarity as tsim

KINDS = ["jaccard", "cosine", "tfidf-cosine", "jaccard-weighted"]


def _features(seed=0, n=150, d=300, density=0.05):
    """Sparse non-negative features with an all-zero row; n and d exceed
    the L1 distance's row and feature blocks (64, 256)."""
    rs = np.random.RandomState(seed)
    f = rs.rand(n, d) * (rs.rand(n, d) < density)
    f[7] = 0.0
    return f.astype(np.float32)


@pytest.mark.parametrize("fill", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_similarity_function_matches_jax(kind, fill):
    f = _features()
    got = tsim.similarity_function(kind)(f, fill_diagonal=fill,
                                         device="cpu")
    want = np.asarray(jsim.similarity_function(kind)(f, fill_diagonal=fill))
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_scipy_and_tensor_inputs():
    """scipy.sparse input densifies; a tensor input stays on its device;
    binary cosine and the helpers agree with the JAX package."""
    f = _features(1)
    csr = sp.csr_matrix(f)
    np.testing.assert_allclose(
        tsim.cosine_similarity(csr, device="cpu").numpy(),
        np.asarray(jsim.cosine_similarity(csr)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tsim.cosine_similarity(torch.as_tensor(f), assume_binary=True
                               ).numpy(),
        np.asarray(jsim.cosine_similarity(f, assume_binary=True)),
        rtol=0, atol=1e-6)
    for name in ("normalize_features", "normalize_binary_features",
                 "tfidf_transform"):
        np.testing.assert_allclose(
            getattr(tsim, name)(f, device="cpu").numpy(),
            np.asarray(getattr(jsim, name)(f)), rtol=0, atol=1e-6,
            err_msg=name)


def test_l1_distance_is_blocked_and_exact():
    """The blocked L1 matrix equals the direct one on small integers."""
    rs = np.random.RandomState(2)
    f = rs.randint(0, 4, (70, 300)).astype(np.float32)
    want = np.abs(f[:, None, :] - f[None, :, :]).sum(-1)
    got = tsim._l1_distance_matrix(torch.as_tensor(f), block=16,
                                   feature_block=64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_errors():
    with pytest.raises(ValueError, match="non-negative"):
        tsim.jaccard_similarity_weighted(-np.ones((3, 2)), device="cpu")
    with pytest.raises(ValueError, match="Unknown similarity"):
        tsim.similarity_function("euclid")
