"""The port's entry points default to the card and never quietly to the
CPU: without a card a missing device raises, naming the entry point, and
``device="cpu"`` gives the CPU tensors.  (The ``*_defaults_to_cpu_*``
tests keep their earlier names; they now check the named-CPU result.)"""
import numpy as np
import pandas as pd
import pytest
import torch

from polara_tpu_torch.data import RecommenderData
from polara_tpu_torch.datasets.synthetic import make_realistic_coo_device
from polara_tpu_torch.models import SVDModel
from polara_tpu_torch.ops.scoring import ChunkedTestData
from polara_tpu_torch.ops.sparse import (CooMatrix, coo_from_arrays,
                                         dense_from_coo)
from polara_tpu_torch.runtime import device as rdevice
from polara_tpu_torch.runtime.checkpoint import load_factors, save_factors
from polara_tpu_torch.runtime.convert import factors_from_jax


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _coo_inputs():
    rs = np.random.RandomState(4)
    idx = np.stack([rs.randint(0, 9, 50), rs.randint(0, 11, 50)], axis=1)
    return idx, rs.rand(50), (9, 11)


def _plan_inputs():
    rs = np.random.RandomState(0)
    rows = np.sort(rs.randint(0, 30, 200))
    cols = rs.randint(0, 40, 200)
    vals = rs.rand(200).astype(np.float32)
    return rows, cols, vals


def _data():
    frame = pd.DataFrame({"userid": [0, 0, 1, 1, 2],
                          "movieid": [0, 1, 0, 2, 1],
                          "rating": [5, 4, 3, 5, 4]})
    return RecommenderData(frame, "userid", "movieid", "rating",
                           verbose=False)


def _checkpoint(tmp_path):
    path = str(tmp_path / "factors.npz")
    save_factors(path, {"v": np.ones((3, 2), np.float32)})
    return path


# entry point name (as the error names it) -> call with a missing device
ENTRY_POINTS = {
    "SVDModel": lambda tmp: SVDModel(_data()),
    "make_realistic_coo_device": lambda tmp: make_realistic_coo_device(
        n_users=20, n_items=30, n_events=200),
    "ChunkedTestData.build": lambda tmp: ChunkedTestData.build(
        *_plan_inputs(), n_users=30, n_items=40, chunk_users=8),
    "CooMatrix.from_numpy": lambda tmp: CooMatrix.from_numpy(
        _coo_inputs()[0][:, 0], _coo_inputs()[0][:, 1], _coo_inputs()[1],
        (9, 11)),
    "coo_from_arrays": lambda tmp: coo_from_arrays(*_coo_inputs()),
    "dense_from_coo": lambda tmp: dense_from_coo(*_coo_inputs()),
    "factors_from_jax": lambda tmp: factors_from_jax({"v": np.ones(3)}),
    "load_factors": lambda tmp: load_factors(_checkpoint(tmp)),
}


@pytest.mark.parametrize("card,want", [(False, "cpu"), (True, "cuda")])
def test_default_device_follows_the_card(monkeypatch, card, want):
    """With a card the default is the card; without one the default
    raises and the CPU (``want``) must be named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    if card:
        assert rdevice.resolve_device(None, "entry") == torch.device(want)
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            rdevice.resolve_device(None, "entry")
    assert rdevice.resolve_device(want, "entry") == torch.device(want)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_card(no_card, tmp_path, name):
    with pytest.raises(RuntimeError, match=rf"^{name}: no CUDA device"):
        ENTRY_POINTS[name](tmp_path)


def test_chunked_test_data_defaults_to_cpu_without_card(no_card):
    """Without a card the CPU is named: ``device="cpu"`` gives the plan on
    the CPU (the default raises, see above)."""
    rows, cols, vals = _plan_inputs()
    plan = ChunkedTestData.build(rows, cols, vals, n_users=30, n_items=40,
                                 chunk_users=8, device="cpu")
    assert plan.device == torch.device("cpu")
    assert len(plan.chunks) == 4
    got_rows = torch.cat([c.rows[c.valid] + c.start for c in plan.chunks])
    got_cols = torch.cat([c.cols[c.valid] for c in plan.chunks])
    got_vals = torch.cat([c.vals[c.valid] for c in plan.chunks])
    for chunk in plan.chunks:
        for t in chunk[1:]:
            assert t.device.type == "cpu"
    np.testing.assert_array_equal(got_rows.numpy(), rows)
    np.testing.assert_array_equal(got_cols.numpy(), cols)
    np.testing.assert_array_equal(got_vals.numpy(), vals)


def test_realistic_coo_defaults_to_cpu_without_card(no_card):
    geo = dict(n_users=60, n_items=80, n_events=1200, seed=2, row_chunk=32)
    got = make_realistic_coo_device(**geo, device="cpu")
    again = make_realistic_coo_device(**geo, device=torch.device("cpu"))
    for a, b in zip(got, again):
        assert a.device.type == "cpu"
        assert torch.equal(a, b)


def test_factors_from_jax_defaults_to_cpu_without_card(no_card):
    rs = np.random.RandomState(3)
    factors = {"item_factors": rs.randn(7, 3), "user_factors": None}
    got = factors_from_jax(factors, device="cpu")
    assert got["user_factors"] is None
    assert got["item_factors"].device.type == "cpu"
    np.testing.assert_array_equal(got["item_factors"].numpy(),
                                  factors["item_factors"].astype(np.float32))


def test_coo_matrix_defaults_to_cpu_without_card(no_card):
    idx, val, shape = _coo_inputs()
    order = np.argsort(idx[:, 0], kind="stable")
    for got in (CooMatrix.from_numpy(idx[:, 0], idx[:, 1], val, shape,
                                     device="cpu"),
                coo_from_arrays(idx, val, shape, device="cpu")):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.rows.numpy(), idx[order, 0])
        np.testing.assert_array_equal(got.cols.numpy(), idx[order, 1])
        np.testing.assert_array_equal(got.vals.numpy(),
                                      val[order].astype(np.float32))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_dense_from_coo_defaults_to_cpu_without_card(no_card, as_tensor):
    idx, val, shape = _coo_inputs()
    want = np.zeros(shape)
    np.add.at(want, (idx[:, 0], idx[:, 1]), val)
    if as_tensor:
        idx, val = torch.as_tensor(idx), torch.as_tensor(val)
    got = dense_from_coo(idx, val, shape, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_model_and_checkpoint_on_named_cpu(no_card, tmp_path):
    model = SVDModel(_data(), device="cpu")
    assert model.device == torch.device("cpu")
    factors, _ = load_factors(_checkpoint(tmp_path), device="cpu")
    assert factors["v"].device.type == "cpu"
    assert torch.equal(factors["v"], torch.ones((3, 2)))
