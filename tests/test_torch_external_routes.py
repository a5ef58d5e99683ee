"""The scoring route and the timers under the adapters: the fused route at
any rank (as the JAX route takes any rank), and timers that wait for every
card (CPU; the card's side is in ``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu.models import SVDModel as JaxSVD
from polara_tpu_torch import config as tconfig
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.models import SVDModel as TorchSVD
from polara_tpu_torch.ops import fused_topk
from polara_tpu_torch.runtime import timing

RANK = 300


def _data(cls, frame):
    data = cls(frame.copy(), "userid", "movieid", "rating", seed=0,
               verbose=False)
    data.warm_start = False
    data.holdout_size = 2
    data.prepare()
    return data


def test_rank_300_takes_the_fused_route(monkeypatch):
    """Dyadic factors at rank 300 (every score exact in f32): the route
    choice takes the fused route, whose picks equal the unfused route's
    and the JAX package's bit for bit; the wrapper's CUDA-side input
    checks, run on the CPU inputs, accept the rank."""
    events = make_synthetic_interactions(n_users=60, n_items=120,
                                         n_events=1500, seed=0)
    rs = np.random.RandomState(4)
    jdata, tdata = _data(JaxData, events), _data(TorchData, events)
    n_items = tdata.index.itemid.shape[0]
    v = np.clip(np.round(rs.randn(n_items, RANK) * 4) / 4, -2, 2)
    factors = {"userid": None, "movieid": v, "singular_values": np.ones(RANK)}

    ref = JaxSVD(jdata)
    ref.verbose = False
    ref.rank = RANK
    ref.factors = {k: None if x is None else np.asarray(x, np.float32)
                   for k, x in factors.items()}
    ref._is_ready = True
    want = ref.recommendations

    port = TorchSVD(tdata, device="cpu")
    port.verbose = False
    port.rank = RANK
    port.set_factors({k: None if x is None else torch.as_tensor(
        x, dtype=torch.float32) for k, x in factors.items()})
    checked = []
    plain = fused_topk.fused_score_topk_reference

    def spied(proj, items, seen_bits, k, filter_seen=True,
              n_valid_cols=None, return_values=False):
        n_valid = min(items.shape[0], n_valid_cols if n_valid_cols
                      is not None else items.shape[0])
        fused_topk._check_kernel_inputs(proj, items, seen_bits, n_valid,
                                        filter_seen)
        checked.append(proj.shape[1])
        return plain(proj, items, seen_bits, k, filter_seen=filter_seen,
                     n_valid_cols=n_valid_cols, return_values=return_values)

    monkeypatch.setattr(fused_topk, "fused_score_topk_reference", spied)
    saved = tconfig.get_default("fused_scoring")
    try:
        tconfig.set_default("fused_scoring", False)
        unfused = port.recommendations.copy()
        tconfig.set_default("fused_scoring", True)
        port._recommendations = None
        assert port.uses_fused_scoring(port.score_params())
        fused = port.recommendations
    finally:
        tconfig.set_default("fused_scoring", saved)
    assert checked and set(checked) == {RANK}
    np.testing.assert_array_equal(fused, unfused)
    np.testing.assert_array_equal(fused, want)


@pytest.mark.parametrize("rank", [1, 257, 520])
def test_kernel_input_checks_take_any_rank(rank):
    proj = torch.zeros((3, rank))
    items = torch.zeros((5, rank))
    bits = torch.zeros((3, 1), dtype=torch.int32)
    fused_topk._check_kernel_inputs(proj, items, bits, 5, True)
    with pytest.raises(ValueError, match="rank"):
        fused_topk._check_kernel_inputs(proj[:, :0].contiguous(),
                                        items[:, :0].contiguous(), bits, 5,
                                        True)


def test_timers_wait_for_every_card(monkeypatch):
    """``_sync`` (behind ``track_time`` and ``timed_blocked``) waits for
    each of the visible cards once CUDA is initialized, not only the
    current one."""
    waited = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: waited.append(device))
    timing._sync()
    assert waited == [0, 1, 2, 3]
    waited.clear()
    result, seconds = timing.timed_blocked(lambda x: x + 1, 1)
    assert result == 2 and seconds >= 0
    assert waited == [0, 1, 2, 3] * 2
    waited.clear()
    store = []
    with timing.track_time(store):
        pass
    assert len(store) == 1 and waited == [0, 1, 2, 3] * 2


def test_timers_do_not_touch_an_uninitialized_cuda(monkeypatch):
    waited = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: waited.append(device))
    timing._sync()
    assert waited == []
