"""The port's host data tier (``polara_tpu_torch.data``) against
``polara_tpu.data`` on the ``conftest.py`` fixtures: splits, index maps
and the COO exports must be identical."""
import numpy as np
import pandas as pd
import pytest

from polara_tpu.data import RecommenderData as JaxData
from polara_tpu_torch.data import RecommenderData as TorchData

SCENARIOS = {
    "warm_start": dict(),
    "known_users_holdout_1": dict(warm_start=False, holdout_size=1),
    "random_holdout": dict(random_holdout=True, holdout_size=2),
    "test_ratio_0": dict(warm_start=False, test_ratio=0, holdout_size=2),
}


def _prepared(cls, frame, config):
    data = cls(frame.copy(), "userid", "movieid", "rating", seed=0,
               verbose=False)
    for name, value in config.items():
        setattr(data, name, value)
    data.prepare()
    return data


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_prepare_and_exports_identical(synthetic_interactions, scenario):
    config = SCENARIOS[scenario]
    ref = _prepared(JaxData, synthetic_interactions, config)
    port = _prepared(TorchData, synthetic_interactions, config)

    pd.testing.assert_frame_equal(port.training, ref.training)
    pd.testing.assert_frame_equal(port.test.holdout, ref.test.holdout)
    if ref.test.testset is None:
        assert port.test.testset is None
    else:
        pd.testing.assert_frame_equal(port.test.testset, ref.test.testset)
    pd.testing.assert_frame_equal(port.index.itemid, ref.index.itemid)
    pd.testing.assert_frame_equal(port.index.userid.training,
                                  ref.index.userid.training)

    for got, want in zip(port.to_coo(), ref.to_coo()):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for got, want in zip(port.test_to_coo(), ref.test_to_coo()):
        np.testing.assert_array_equal(got, want)
    assert port.get_test_shape() == ref.get_test_shape()
