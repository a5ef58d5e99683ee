"""The port's entry points default to the card when one is present and to
the CPU otherwise; with no card the default changes no result."""
import numpy as np
import pytest
import torch

from polara_tpu_torch.datasets.synthetic import make_realistic_coo_device
from polara_tpu_torch.ops.scoring import ChunkedTestData
from polara_tpu_torch.ops.sparse import (CooMatrix, coo_from_arrays,
                                         dense_from_coo)
from polara_tpu_torch.runtime import device as rdevice
from polara_tpu_torch.runtime.convert import factors_from_jax


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("card,want", [(False, "cpu"), (True, "cuda")])
def test_default_device_follows_the_card(monkeypatch, card, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    assert rdevice.resolve_device(None) == torch.device(want)
    assert rdevice.resolve_device("cpu") == torch.device("cpu")


def test_chunked_test_data_defaults_to_cpu_without_card(no_card):
    rs = np.random.RandomState(0)
    rows = np.sort(rs.randint(0, 30, 200))
    cols = rs.randint(0, 40, 200)
    vals = rs.rand(200).astype(np.float32)
    plan = ChunkedTestData.build(rows, cols, vals, n_users=30, n_items=40,
                                 chunk_users=8)
    ref = ChunkedTestData.build(rows, cols, vals, n_users=30, n_items=40,
                                chunk_users=8, device="cpu")
    assert plan.device == torch.device("cpu")
    assert len(plan.chunks) == len(ref.chunks)
    for got, want in zip(plan.chunks, ref.chunks):
        assert got.start == want.start
        for a, b in zip(got[1:], want[1:]):
            assert a.device.type == "cpu"
            assert torch.equal(a, b)


def test_realistic_coo_defaults_to_cpu_without_card(no_card):
    geo = dict(n_users=60, n_items=80, n_events=1200, seed=2, row_chunk=32)
    got = make_realistic_coo_device(**geo)
    want = make_realistic_coo_device(**geo, device="cpu")
    for a, b in zip(got, want):
        assert a.device.type == "cpu"
        assert torch.equal(a, b)


def test_factors_from_jax_defaults_to_cpu_without_card(no_card):
    rs = np.random.RandomState(3)
    factors = {"item_factors": rs.randn(7, 3), "user_factors": None}
    got = factors_from_jax(factors)
    assert got["user_factors"] is None
    assert got["item_factors"].device.type == "cpu"
    assert torch.equal(got["item_factors"],
                       factors_from_jax(factors, device="cpu")["item_factors"])


def _coo_inputs():
    rs = np.random.RandomState(4)
    idx = np.stack([rs.randint(0, 9, 50), rs.randint(0, 11, 50)], axis=1)
    return idx, rs.rand(50), (9, 11)


def test_coo_matrix_defaults_to_cpu_without_card(no_card):
    idx, val, shape = _coo_inputs()
    for got, want in [
            (CooMatrix.from_numpy(idx[:, 0], idx[:, 1], val, shape),
             CooMatrix.from_numpy(idx[:, 0], idx[:, 1], val, shape,
                                  device="cpu")),
            (coo_from_arrays(idx, val, shape),
             coo_from_arrays(idx, val, shape, device="cpu"))]:
        assert got.device.type == "cpu"
        for a, b in [(got.rows, want.rows), (got.cols, want.cols),
                     (got.vals, want.vals)]:
            assert a.device.type == "cpu"
            assert torch.equal(a, b)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_dense_from_coo_defaults_to_cpu_without_card(no_card, as_tensor):
    idx, val, shape = _coo_inputs()
    if as_tensor:
        idx, val = torch.as_tensor(idx), torch.as_tensor(val)
    got = dense_from_coo(idx, val, shape)
    assert got.device.type == "cpu"
    assert torch.equal(got, dense_from_coo(idx, val, shape, device="cpu"))
