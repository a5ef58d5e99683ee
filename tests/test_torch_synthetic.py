"""Port-side data generators and chunk planner against the JAX package."""
import numpy as np
import pandas as pd
import pytest
import torch

from polara_tpu.datasets import synthetic as jsynth
from polara_tpu.runtime.memory import plan_user_chunks as jax_plan
from polara_tpu_torch.datasets import synthetic as tsynth
from polara_tpu_torch.runtime.memory import plan_user_chunks


def test_make_synthetic_interactions_identical():
    kwargs = dict(n_users=80, n_items=50, n_events=900, seed=3,
                  include_time=True)
    pd.testing.assert_frame_equal(
        tsynth.make_synthetic_interactions(**kwargs),
        jsynth.make_synthetic_interactions(**kwargs))


def test_realistic_coo_device_calibration():
    """Same per-user counts as the JAX generator (same numpy stream);
    the torch-drawn parts are checked by their statistics only."""
    geo = dict(n_users=300, n_items=400, n_events=12_000)
    rows, cols, vals = tsynth.make_realistic_coo_device(**geo, seed=1,
                                                        row_chunk=128,
                                                        device="cpu")
    rs = np.random.RandomState(1)
    user_w = 1.0 / np.arange(1, 301) ** 0.6
    want_counts = jsynth._largest_remainder_counts(
        12_000, user_w / user_w.sum(), 5, 200, rs)
    rows, cols, vals = rows.numpy(), cols.numpy(), vals.numpy()
    np.testing.assert_array_equal(np.bincount(rows, minlength=300),
                                  want_counts)
    assert (np.diff(rows) >= 0).all()
    assert len(np.unique(rows * 400 + cols)) == len(rows)
    assert set(np.unique(vals)) <= {1.0, 2.0, 3.0, 4.0, 5.0}
    hist = np.bincount(vals.astype(int), minlength=6)[1:] / len(vals)
    np.testing.assert_allclose(hist, tsynth.ML1M_RATING_HIST, atol=0.01)
    item_counts = np.bincount(cols, minlength=400)
    assert item_counts[:40].mean() > 3 * item_counts[-200:].mean()  # Zipf


@pytest.mark.parametrize("args", [(69_878, 10_677, 1, 4, None, 4.0),
                                  (1000, 500, 1, 4, 100, 0.001),
                                  (37, 9, 3, 8, None, 1e-6)])
def test_plan_user_chunks_identical(args):
    n_users, n_items, mult, itemsize, max_chunk, budget = args
    kwargs = dict(scores_multiplier=mult, itemsize=itemsize,
                  budget_gb=budget, max_chunk=max_chunk)
    assert plan_user_chunks(n_users, n_items, **kwargs) == \
        jax_plan(n_users, n_items, **kwargs)
