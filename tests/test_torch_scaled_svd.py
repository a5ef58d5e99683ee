"""ScaledSVD (PureSVD-s, EigenRec) of the port against ``polara_tpu``'s on
the ``conftest.py`` fixture: the rescaled matrix, carried-factor
recommendations, a self-built solve, and the dense-block cache."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from polara_tpu.models import ScaledSVD as JaxScaled
from polara_tpu.models.svd import rescale_coo as jax_rescale
from polara_tpu.ops.sparse import CooMatrix as JaxCoo
from polara_tpu_torch.models import ScaledSVD as TorchScaled
from polara_tpu_torch.models import SVDModel as TorchSVD
from polara_tpu_torch.models.svd import rescale_coo
from polara_tpu_torch.ops.sparse import CooMatrix
from polara_tpu_torch.runtime.convert import factors_from_jax

from test_torch_svd_model import _assert_metrics_close, _jax_factors, _pair

RANK = 5


def _coo(seed=0, n_rows=40, n_cols=30, nnz=500):
    rs = np.random.RandomState(seed)
    pairs = np.unique(np.stack([rs.randint(0, n_rows, nnz),
                                rs.randint(0, n_cols, nnz)], 1), axis=0)
    vals = rs.randint(1, 6, len(pairs)).astype(np.float32)
    return pairs[:, 0], pairs[:, 1], vals, (n_rows, n_cols)


@pytest.mark.parametrize("scaling,axis", [(0.4, 0), (0.5, 1), (1.3, 0),
                                          (0.2, 1), (1, 0)])
def test_rescale_coo_exact(scaling, axis):
    """Rescaled values identical to the JAX package's, bit for bit (counts
    here stay below the first count where XLA's f32 pow is 1 ulp off the
    correctly rounded factor, see ``rescale_coo``)."""
    rows, cols, vals, shape = _coo()
    port = CooMatrix.from_numpy(rows, cols, vals, shape, device="cpu")
    ref = JaxCoo(jnp.asarray(port.rows.numpy()),
                 jnp.asarray(port.cols.numpy()),
                 jnp.asarray(port.vals.numpy()), shape)
    got = rescale_coo(port, scaling, axis)
    want = jax_rescale(ref, scaling, axis)
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    assert got.vals.dtype == torch.float32


def _scaled(cls, data, device=None, col_scaling=0.4, row_scaling=1):
    model = cls(data) if device is None else cls(data, device=device)
    model.verbose = False
    model.rank = RANK
    model.col_scaling = col_scaling
    model.row_scaling = row_scaling
    return model


def test_carried_factors_identical(synthetic_interactions):
    """JAX ScaledSVD factors carried over: identical ids, evaluate()
    within 1e-6 (identical ids; the bound covers f64 summation order)."""
    jdata, tdata = _pair(synthetic_interactions)
    ref = _scaled(JaxScaled, jdata)
    port = _scaled(TorchScaled, tdata, device="cpu")
    assert port.method == ref.method == "PureSVD-s"
    port.set_factors(factors_from_jax(_jax_factors(_built(ref)),
                                      device="cpu"))
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)
    _assert_metrics_close(port.evaluate(), ref.evaluate(), atol=1e-6)


def _built(model):
    model.build()
    return model


@pytest.mark.parametrize("scalings", [(0.4, 1), (0.6, 0.8)])
def test_self_built_singular_values(synthetic_interactions, scalings):
    """The port's own solve on the rescaled matrix: singular values within
    1e-4 relative of the JAX package's."""
    jdata, tdata = _pair(synthetic_interactions)
    ref = _built(_scaled(JaxScaled, jdata, None, *scalings))
    port = _built(_scaled(TorchScaled, tdata, "cpu", *scalings))
    np.testing.assert_allclose(port.factors["singular_values"].numpy(),
                               np.asarray(ref.factors["singular_values"]),
                               rtol=1e-4)


def test_scaling_change_evicts_only_own_block(synthetic_interactions):
    """Two ScaledSVD models on one data object: a new scaling on one
    evicts that model's previous dense block, never the sibling's, and
    the plain training block stays."""
    _, tdata = _pair(synthetic_interactions)
    plain = TorchSVD(tdata, device="cpu")
    plain.verbose = False
    plain.rank = RANK
    plain.build()
    first = _built(_scaled(TorchScaled, tdata, "cpu", 0.4))
    second = _built(_scaled(TorchScaled, tdata, "cpu", 0.6))
    cache = tdata._device_matrix_cache
    plain_keys = [k for k in cache if k[2] is True]   # dense=True entries
    key_first, key_second = first._last_dense_key, second._last_dense_key
    assert len(plain_keys) == 1
    assert key_first in cache and key_second in cache
    first.col_scaling = 0.8
    first.build()
    assert key_first not in cache
    assert key_second in cache and plain_keys[0] in cache
    assert first._last_dense_key in cache
    assert first._last_dense_key != key_first
