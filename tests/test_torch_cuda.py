"""Kernel tests that need an NVIDIA GPU (``cuda`` marker; they skip
without one).  This file imports neither jax nor the JAX package, so it
runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which imports jax.)
"""
import numpy as np
import pytest
import torch

from polara_tpu_torch.ops import fused_topk as tf


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, n_users, n_items, rank, nnz, device):
    """Dyadic factors (multiples of 1/4): every score is exact in f32, so
    kernel and plain version must agree bit for bit, ties included."""
    rs = np.random.RandomState(seed)
    proj = np.clip(np.round(rs.randn(n_users, rank) * 4) / 4, -2, 2)
    items = np.clip(np.round(rs.randn(n_items, rank) * 4) / 4, -2, 2)
    pairs = np.unique(np.stack([rs.randint(0, n_users, nnz),
                                rs.randint(0, n_items, nnz)], 1), axis=0)
    bits = tf.pack_seen_bits(torch.as_tensor(pairs[:, 0], device=device),
                             torch.as_tensor(pairs[:, 1], device=device),
                             n_users, n_items)
    return (torch.as_tensor(proj, dtype=torch.float32, device=device),
            torch.as_tensor(items, dtype=torch.float32, device=device), bits)


# (seed, n_users, n_items, rank, k, filter_seen, n_valid)
KERNEL_CASES = [
    (11, 33, 5000, 16, 20, True, None),
    (13, 16, 4096, 8, 128, True, None),
    (15, 300, 3000, 50, 10, True, None),
    (16, 20, 35, 12, 40, False, 35),          # PAD beyond the catalog
    (17, 64, 1000, 256, 33, False, 900),      # widest rank, masked tail
    # the tiling's edges: users not a multiple of 64, items not a multiple
    # of 128 with n_valid below them, rank 1 / 3 / 256, k 1 / 33 / 128
    (20, 65, 1000, 3, 33, True, 900),
    (21, 63, 1000, 1, 1, True, 1000),
    (22, 65, 777, 256, 128, True, 700),
    (23, 63, 300, 256, 1, False, 250),
    (24, 129, 1000, 3, 128, True, 999),
    (25, 64, 128, 1, 33, True, 128),
    # ranks past the whole-rank staging, walked in slices (520 is not a
    # multiple of the slice)
    (26, 65, 1000, 257, 10, True, 900),
    (27, 129, 777, 300, 128, True, 700),
    (28, 63, 1000, 520, 1, False, 1000),
    (29, 200, 3000, 300, 10, True, 3000),
]
# few users: grids the item split widens (1 user: one tile per split)
FEW_USER_CASES = [
    (30, 1, 3000, 50, 10, True, None),
    (31, 16, 3000, 50, 10, True, 2900),
    (32, 63, 3000, 150, 33, True, None),
    (33, 64, 3000, 50, 128, False, None),
    (34, 65, 3000, 300, 10, True, None),
    (35, 1024, 10_677, 50, 10, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_users,n_items,rank,k,filter_seen,n_valid",
                         KERNEL_CASES)
def test_kernel_matches_plain_version(seed, n_users, n_items, rank, k,
                                      filter_seen, n_valid):
    device = _cuda()
    proj, items, bits = _case(seed, n_users, n_items, rank, 3 * n_users,
                              device)
    before = tf.fused_score_topk.launches
    kv, ki = tf.fused_score_topk(proj, items, bits, k,
                                 filter_seen=filter_seen,
                                 n_valid_cols=n_valid, return_values=True)
    pv, pi = tf.fused_score_topk_reference(proj, items, bits, k,
                                           filter_seen=filter_seen,
                                           n_valid_cols=n_valid,
                                           return_values=True)
    torch.cuda.synchronize()
    assert tf.fused_score_topk.launches == before + 1
    assert torch.equal(ki, pi)
    assert torch.equal(kv, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,n_users,n_items,rank,k,filter_seen,n_valid",
                         FEW_USER_CASES + KERNEL_CASES)
def test_item_split_is_bit_identical(seed, n_users, n_items, rank, k,
                                     filter_seen, n_valid):
    """One split, the rule's count and the largest (one tile a split) give
    the same ids and values, equal to the plain version's (dyadic factors:
    exact scores, so ties decide picks); one counted launch each."""
    device = _cuda()
    proj, items, bits = _case(seed, n_users, n_items, rank, 3 * n_users,
                              device)
    n_valid_eff = n_items if n_valid is None else n_valid
    rule = tf.kernel_splits(device, n_users, rank, k, n_valid_eff)
    largest = tf.item_tiles(n_valid_eff, rank)
    if n_users <= 64 and largest > 1:
        assert rule > 1     # a lone user block leaves slots to fill
    pv, pi = tf.fused_score_topk_reference(proj, items, bits, k,
                                           filter_seen=filter_seen,
                                           n_valid_cols=n_valid,
                                           return_values=True)
    for splits in (1, None, largest):
        before = tf.fused_score_topk.launches
        kv, ki = tf.fused_score_topk(proj, items, bits, k,
                                     filter_seen=filter_seen,
                                     n_valid_cols=n_valid,
                                     return_values=True, _splits=splits)
        torch.cuda.synchronize()
        assert tf.fused_score_topk.launches == before + 1
        assert torch.equal(ki, pi), f"splits={splits} (rule {rule})"
        assert torch.equal(kv, pv), f"splits={splits} (rule {rule})"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 33, 128])
@pytest.mark.parametrize("rank", [257, 300, 520])
def test_sliced_ring_matches_plain_version(rank, k):
    """Ranks past the whole-rank staging go through the two-stage ring of
    32-row steps over 256-item tiles (257, 300 and 520 end on a partial
    step); several tiles per block, so steps cross tile boundaries, and
    the selection from registers sees ties across interleaved columns.
    Dyadic factors: exact."""
    device = _cuda()
    proj, items, bits = _case(rank + k, 130, 1500, rank, 600, device)
    pv, pi = tf.fused_score_topk_reference(proj, items, bits, k,
                                           n_valid_cols=1400,
                                           return_values=True)
    kv, ki = tf.fused_score_topk(proj, items, bits, k, n_valid_cols=1400,
                                 return_values=True, _splits=1)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10])
def test_sliced_ring_keeps_the_tie_rule(k):
    """Integer factors in {0, 1, 2} at rank 300: scores take few values, so
    ties between a lane's interleaved columns decide most picks; every
    split count must still give the plain version's lowest columns."""
    device = _cuda()
    rs = np.random.RandomState(k)
    proj = torch.as_tensor(rs.randint(0, 3, (70, 300)), dtype=torch.float32,
                           device=device)
    items = torch.as_tensor(rs.randint(0, 3, (1300, 300)),
                            dtype=torch.float32, device=device)
    bits = torch.zeros((70, 41), dtype=torch.int32, device=device)
    pv, pi = tf.fused_score_topk_reference(proj, items, bits, k,
                                           return_values=True)
    for splits in (1, None, tf.item_tiles(1300, 300)):
        kv, ki = tf.fused_score_topk(proj, items, bits, k,
                                     return_values=True, _splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kv, pv), splits


@pytest.mark.cuda
def test_kernel_occupancy_and_splits_on_the_card():
    """The occupancy query reports the blocks the launch bounds and shared
    memory allow (3 per SM at rank 50, 2 on the sliced ring at k <= 32,
    one at rank 150), and the rule widens a serving batch only."""
    device = _cuda()
    assert tf.kernel_blocks_per_sm(device, 50, 10) == 3
    assert tf.kernel_blocks_per_sm(device, 300, 10) == 2
    assert tf.kernel_blocks_per_sm(device, 150, 10) == 1
    assert tf.kernel_splits(device, 69_878, 50, 10, 10_677) == 1
    assert tf.kernel_splits(device, 1_024, 50, 10, 10_677) > 1
    with pytest.raises(ValueError, match="splits"):
        proj, items, bits = _case(1, 8, 300, 4, 10, device)
        tf.fused_score_topk(proj, items, bits, 5, _splits=4)


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back():
    device = _cuda()
    proj, items, bits = _case(1, 8, 100, 4, 10, device)
    before = tf.fused_score_topk.launches
    with pytest.raises(TypeError):
        tf.fused_score_topk(proj.double(), items, bits, 5)
    with pytest.raises(ValueError):
        tf.fused_score_topk(proj, items.cpu(), bits, 5)
    with pytest.raises(ValueError, match="rank"):
        empty = torch.zeros((8, 0), device=device)
        tf.fused_score_topk(empty, torch.zeros((100, 0), device=device),
                            bits, 5)
    assert tf.fused_score_topk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("rank,width", [(10, 150), (150, 256), (250, 300),
                                        (10, 520)])
def test_zero_padded_rank_gives_truncated_picks(rank, width):
    """A rank sweep pads truncated factors with zero columns up to the top
    rank: each score is an fmaf chain from 0, so the zero terms leave it
    exact and the kernel's ids and values equal those of the truncated
    factors bit for bit (Gaussian factors, no dyadic help)."""
    device = _cuda()
    rs = np.random.RandomState(rank)
    n_users, n_items = 300, 3000
    proj = torch.zeros((n_users, width), device=device)
    items = torch.zeros((n_items, width), device=device)
    proj[:, :rank] = torch.as_tensor(rs.randn(n_users, rank),
                                     dtype=torch.float32, device=device)
    items[:, :rank] = torch.as_tensor(rs.randn(n_items, rank),
                                      dtype=torch.float32, device=device)
    pairs = np.unique(np.stack([rs.randint(0, n_users, 9000),
                                rs.randint(0, n_items, 9000)], 1), axis=0)
    bits = tf.pack_seen_bits(torch.as_tensor(pairs[:, 0], device=device),
                             torch.as_tensor(pairs[:, 1], device=device),
                             n_users, n_items)
    pv, pi = tf.fused_score_topk(proj, items, bits, 10, return_values=True)
    tv, ti = tf.fused_score_topk(proj[:, :rank].contiguous(),
                                 items[:, :rank].contiguous(), bits, 10,
                                 return_values=True)
    torch.cuda.synchronize()
    assert torch.equal(pi, ti)
    assert torch.equal(pv, tv)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
@pytest.mark.parametrize("filter_seen", [True, False])
def test_logical_mesh_on_one_card_equals_single_device(shape, filter_seen):
    """A mesh whose entries go to the visible cards in turn (on one card a
    logical mesh, every entry ``cuda:0``): the same ids and values as the
    single-device route on one projection (dyadic factors, exact scores),
    with one kernel launch per shard and chunk."""
    from polara_tpu_torch.ops.scoring import (ChunkedTestData,
                                              run_scoring_fused)
    from polara_tpu_torch.runtime.mesh import make_mesh
    device = _cuda()
    rs = np.random.RandomState(5)
    n_users, n_items, rank, chunk_users = 301, 1001, 16, 160
    proj = torch.as_tensor(np.clip(np.round(rs.randn(n_users, rank) * 4) / 4,
                                   -2, 2), dtype=torch.float32, device=device)
    panel = torch.as_tensor(np.clip(np.round(rs.randn(n_items, rank) * 4) / 4,
                                    -2, 2), dtype=torch.float32,
                            device=device)
    pairs = np.unique(np.stack([rs.randint(0, n_users, 9000),
                                rs.randint(0, n_items, 9000)], 1), axis=0)
    plan = ChunkedTestData.build(pairs[:, 0], pairs[:, 1],
                                 np.ones(len(pairs)), n_users, n_items,
                                 chunk_users=chunk_users, device=device)
    params = {"item_panel": panel, "proj": proj}

    def fixed_proj(params, chunk):
        return params["proj"][chunk.users]

    def route(mesh):
        return run_scoring_fused(plan, fixed_proj, params, 10,
                                 filter_seen=filter_seen,
                                 n_valid_cols=n_items, on_device=True,
                                 item_order="popularity", mesh=mesh,
                                 return_values=True)

    want_vals, want_ids = route(None)
    n_cards = torch.cuda.device_count()
    mesh = make_mesh(devices=[torch.device("cuda", i % n_cards)
                              for i in range(shape[0] * shape[1])],
                     shape=shape)
    before = tf.fused_score_topk.launches
    vals, ids = route(mesh)
    torch.cuda.synchronize()
    assert (tf.fused_score_topk.launches - before
            == shape[0] * shape[1] * len(plan.chunks))
    assert torch.equal(ids, want_ids)
    assert torch.equal(vals, want_vals)


@pytest.mark.cuda
def test_projections_are_bit_reproducible_on_the_card():
    """``SVDModel.proj_chunk`` and the COO operator's products run as sorted
    segment sums: two calls give identical bits (``index_add_``'s atomics
    and cuSPARSE's CSR product did not), and they match the CPU's within
    1e-5 of the largest value."""
    from polara_tpu_torch.models.svd import SVDModel
    from polara_tpu_torch.ops.scoring import ChunkedTestData
    from polara_tpu_torch.ops.sparse import CooMatrix
    device = _cuda()
    rs = np.random.RandomState(9)
    n_users, n_items, rank = 5000, 2000, 50
    pairs = np.unique(np.stack([rs.randint(0, n_users, 300_000),
                                rs.randint(0, n_items, 300_000)], 1), axis=0)
    vals = rs.rand(len(pairs)).astype(np.float32)
    v = torch.as_tensor(rs.randn(n_items, rank), dtype=torch.float32)
    u = torch.as_tensor(rs.randn(n_users, rank), dtype=torch.float32)
    plan = ChunkedTestData.build(pairs[:, 0], pairs[:, 1], vals, n_users,
                                 n_items, device=device)
    chunk = plan.chunks[0]
    params = {"item_factors": v.to(device)}
    first = SVDModel.proj_chunk(params, chunk)
    assert torch.equal(first, SVDModel.proj_chunk(params, chunk))
    cpu_plan = ChunkedTestData.build(pairs[:, 0], pairs[:, 1], vals, n_users,
                                     n_items, device="cpu")
    want = SVDModel.proj_chunk({"item_factors": v}, cpu_plan.chunks[0])
    assert (first.cpu() - want).abs().max() <= 1e-5 * want.abs().max()
    op = CooMatrix.from_numpy(pairs[:, 0], pairs[:, 1], vals,
                              (n_users, n_items), device=device).operator()
    vd, ud = v.to(device), u.to(device)
    assert torch.equal(op.mm(vd), op.mm(vd))
    assert torch.equal(op.rmm(ud), op.rmm(ud))


def _ratings(seed=0, n_users=60, n_items=40):
    rs = np.random.RandomState(seed)
    return ((rs.rand(n_users, n_items) < 0.3)
            * rs.randint(1, 6, (n_users, n_items))).astype(np.float32)


@pytest.mark.cuda
def test_ials_on_the_card_matches_the_cpu():
    """Three iALS epochs on the card and on the CPU from one start (the
    CPU's draw): factors within 1e-4 of the largest magnitude; the event
    tier on the card agrees with its dense tier to the same bound."""
    from polara_tpu_torch.ops import implicit as imp
    device = _cuda()
    dense = torch.as_tensor(_ratings())
    start = imp._initial_item_factors(dense.shape[1], 6, 0, torch.float32,
                                      "cpu")
    zeros = torch.zeros((dense.shape[0], 6))
    want = imp._ials_epochs(dense, zeros, start, 1.0, 1.0, 0.01, "log2", 3,
                            16, 8)
    got = imp._ials_epochs(dense.to(device), zeros.to(device),
                           start.to(device), 1.0, 1.0, 0.01, "log2", 3, 16, 8)
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max() <= 1e-4 * w.abs().max()
    rows, cols = torch.nonzero(dense, as_tuple=True)
    full = imp.ials_train(dense.to(device), 6, num_epochs=3)
    events = imp.ials_train_events(rows.to(device), cols.to(device),
                                   dense[rows, cols].to(device), dense.shape,
                                   6, num_epochs=3, tile=8,
                                   batch_entities=16, max_window_events=200)
    assert ((events.item - full.item).abs().max()
            <= 1e-4 * full.item.abs().max())


@pytest.mark.cuda
def test_numpy_weight_callables_run_on_the_card():
    """``np.log2``/``np.log``/``np.sqrt`` as confidence weights run as their
    torch counterparts on a CUDA tensor (a numpy ufunc would raise)."""
    from polara_tpu_torch.ops.implicit import confidence
    device = _cuda()
    values = torch.as_tensor(_ratings(1))
    for weight in (np.log2, np.log, np.sqrt):
        got = confidence(values.to(device), 2.0, weight, 1.0).cpu()
        want = confidence(values, 2.0, weight, 1.0)
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.cuda
def test_bpr_on_the_card_learns_like_the_cpu():
    """BPR on the card and on the CPU (each device's own generator, so the
    draws differ): the last epoch's batch AUC, averaged over three seeds,
    within 0.03 of each other, and each run's above its first epoch's."""
    from polara_tpu_torch.ops.implicit import bpr_train
    device = _cuda()
    rows, cols = np.nonzero(_ratings(2))
    aucs = {}
    for dev in ("cpu", device):
        last = []
        for seed in (0, 1, 2):
            stats = []
            bpr_train(rows, cols, (60, 40), 6, learning_rate=0.05,
                      num_epochs=15, batch_size=64, seed=seed,
                      epoch_stats=stats, device=dev)
            assert stats[-1] > stats[0]
            last.append(stats[-1])
        aucs[str(dev)] = np.mean(last)
    assert abs(aucs["cpu"] - aucs[str(device)]) <= 0.03, aucs


def _serving_case(device, n_items=3000, rank=16, batch=1024, width=100,
                  seed=3):
    """Integer factors and ``batch`` event histories of ``width`` items
    (the last row has seen all but three items)."""
    rs = np.random.RandomState(seed)
    factors = rs.randint(-2, 3, (n_items, rank)).astype(np.float32)
    events = [rs.choice(n_items, width, replace=False).tolist()
              for _ in range(batch - 1)]
    events.append(rs.permutation(n_items)[:n_items - 3].tolist())
    return factors, events


@pytest.mark.cuda
@pytest.mark.parametrize("fold_in", [None, "ials", "ridge"])
def test_serve_steps_match_the_plain_route(fold_in):
    """Each serve step of a bundle on the card at batch 1,024 (100-event
    lists, bucket 128, and dense profiles) launches the kernel once per
    batch; on the step's own ``proj`` the kernel's ids equal the plain
    version's (integer factors: exact scores) or, for the fold-in solves,
    score within 1e-5 of the row's largest |score| of the plain pick at
    each slot.  The ids equal a CPU bundle's (fold-in: the short row's
    fill)."""
    from polara_tpu_torch.runtime.serving import ServingBundle
    device = _cuda()
    factors, events = _serving_case(device)
    spec = None if fold_in is None else {"kind": fold_in}
    bundle = ServingBundle(factors, batch_size=1024, device=device,
                           fold_in=spec)
    cpu = ServingBundle(factors, batch_size=1024, device="cpu", fold_in=spec)
    ids, values, lengths = bundle.assemble_events(events[:-1])
    dev = [None if x is None else torch.as_tensor(x).to(device)
           for x in (ids, values, lengths)]
    profiles = np.zeros((1024, factors.shape[0]), np.float32)
    for row, items in enumerate(events):
        profiles[row, items] = 1 + row % 5
    for inputs in (bundle.events_step_inputs(*dev),
                   bundle.dense_step_inputs(torch.as_tensor(profiles)
                                            .to(device))):
        proj, rows, cols = inputs
        before = tf.fused_score_topk.launches
        got = bundle.rank(inputs)
        assert tf.fused_score_topk.launches == before + 1
        bits = tf.pack_seen_bits(rows, cols, proj.shape[0], factors.shape[0])
        want = tf.fused_score_topk_reference(
            proj.float(), bundle.left_panel, bits, bundle.topk)
        if fold_in is None:
            assert torch.equal(got, want)
        else:
            s64 = proj.double() @ bundle.left_panel.double().T
            scale = s64.abs().amax(1, keepdim=True)
            gap = (s64.gather(1, want.long().clamp(min=0))
                   - s64.gather(1, got.long().clamp(min=0))).abs()
            assert bool((gap <= 1e-5 * scale).all())
    got = bundle.recommend_events(events)
    want = cpu.recommend_events(events)
    if fold_in is None:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-1][3:], want[-1][3:])
    assert sorted(got[-1][3:]) == list(got[-1][3:])


@pytest.mark.cuda
def test_coffee_builds_are_bit_identical_on_the_card():
    """Two ``CoffeeModel`` builds with one seed on the card, on the dense
    tier and on the event tier (sorted segment sums): identical factor
    bits and identical recommendations; the tiers' HR@10 within 0.02."""
    from polara_tpu_torch import config
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets.synthetic import \
        make_synthetic_interactions
    from polara_tpu_torch.models import CoffeeModel
    device = _cuda()
    data = RecommenderData(make_synthetic_interactions(
        n_users=600, n_items=300, n_events=20_000, seed=0), "userid",
        "movieid", "rating", seed=0, verbose=False)
    data.warm_start = False
    data.holdout_size = 1
    data.prepare()
    saved = config.get_default("hbm_score_budget_gb")
    hr = {}
    try:
        for tier, budget in (("dense", saved), ("events", 1e-9)):
            config.set_default("hbm_score_budget_gb", budget)
            runs = []
            for _ in range(2):
                model = CoffeeModel(data, device=device)
                model.verbose = False
                model.mlrank = (13, 10, 2)
                model.seed = 0
                model.build()
                runs.append(model)
            for name, factor in runs[0].factors.items():
                assert torch.equal(factor, runs[1].factors[name]), name
            np.testing.assert_array_equal(runs[0].recommendations,
                                          runs[1].recommendations)
            hr[tier] = runs[0].evaluate("relevance").hr
    finally:
        config.set_default("hbm_score_budget_gb", saved)
    assert abs(hr["dense"] - hr["events"]) <= 0.02, hr


def config_default(name, value):
    """Set a port default; returns the previous value."""
    from polara_tpu_torch import config
    saved = config.get_default(name)
    config.set_default(name, value)
    return saved


def _similarity_data(n_users=600, n_items=300, n_events=20_000):
    """Seeded events with a seeded PSD item similarity (unit diagonal) in
    ``SimilarityDataModel``, known users, one held-out item each."""
    from polara_tpu_torch.data import SimilarityDataModel
    from polara_tpu_torch.datasets.synthetic import \
        make_synthetic_interactions
    events = make_synthetic_interactions(n_users=n_users, n_items=n_items,
                                         n_events=n_events, seed=0)
    ids = np.sort(events["movieid"].unique())
    base = np.random.RandomState(1).randn(len(ids), 8)
    sim = base @ base.T
    sim = 0.5 * sim / np.sqrt(np.outer(np.diag(sim), np.diag(sim)))
    data = SimilarityDataModel(
        events, "userid", "movieid", "rating",
        relations_matrices={"movieid": torch.as_tensor(sim).float()},
        relations_indices={"movieid": ids}, seed=0, verbose=False)
    data.warm_start = False
    data.holdout_size = 1
    data.prepare()
    return data


@pytest.mark.cuda
def test_hybrid_svd_kernel_matches_its_plain_version():
    """HybridSVD built on the card scores through the kernel (counted)
    over its left projector; the same factors made dyadic give the plain
    version's ids on the CPU, ties included; two ``proj_chunk`` calls
    give identical bits."""
    from polara_tpu_torch.models import HybridSVD
    device = _cuda()
    data = _similarity_data()
    model = HybridSVD(data, device=device)
    model.verbose = False
    model.rank = 20
    model.build()
    rs = np.random.RandomState(2)
    factors = {k: None if v is None else torch.as_tensor(
        np.clip(np.round(rs.randn(*v.shape) * 4) / 4, -2, 2),
        dtype=torch.float32) for k, v in model.factors.items()}
    model.set_factors(factors)
    before = tf.fused_score_topk.launches
    got = model.recommendations
    assert tf.fused_score_topk.launches > before
    plain = HybridSVD(data, device="cpu")
    plain.verbose = False
    plain.rank = 20
    plain.set_factors(factors)
    saved = config_default("fused_scoring", True)
    try:
        want = plain.recommendations
    finally:
        config_default("fused_scoring", saved)
    np.testing.assert_array_equal(got, want)
    chunk = model._test_plan.chunks[0]
    params = model.score_params()
    assert torch.equal(HybridSVD.proj_chunk(params, chunk),
                       HybridSVD.proj_chunk(params, chunk))


@pytest.mark.cuda
def test_cold_start_topk_on_the_card_is_the_stable_sort():
    """HybridSVD(cs) on the card: its picks equal a stable descending sort
    of its own score block on the host (ties to the lowest user)."""
    import pandas as pd
    from polara_tpu_torch.data import ItemColdStartSimilarityData
    from polara_tpu_torch.datasets.synthetic import \
        make_synthetic_interactions
    from polara_tpu_torch.models import HybridSVDItemColdStart
    device = _cuda()
    events = make_synthetic_interactions(n_users=600, n_items=300,
                                         n_events=20_000, seed=0)
    ids = np.sort(events["movieid"].unique())
    rs = np.random.RandomState(3)
    features = pd.DataFrame({"genres": [rs.choice(8, rs.randint(1, 4),
                                                  replace=False).tolist()
                                        for _ in ids]}, index=ids)
    base = rs.randn(len(ids), 8)
    sim = base @ base.T
    sim = 0.5 * sim / np.sqrt(np.outer(np.diag(sim), np.diag(sim)))
    data = ItemColdStartSimilarityData(
        events, "userid", "movieid", "rating", item_features=features,
        relations_matrices={"movieid": torch.as_tensor(sim, device=device)},
        relations_indices={"movieid": ids}, seed=0, verbose=False)
    data.prepare()
    model = HybridSVDItemColdStart(data, device=device)
    model.verbose = False
    model.rank = 10
    recs = model.recommendations
    scores = model.compute_cold_scores(None).cpu().numpy()
    want = np.argsort(-scores, axis=1, kind="stable")[:, :model.topk]
    np.testing.assert_array_equal(recs, want)


def _stream_events(seed=11, m=700, n=300, n_events=20_000):
    """Zipf-skewed integer events with duplicate pairs (cell sums stay
    well below 127)."""
    rs = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, n + 1) ** 0.9
    cols = rs.choice(n, size=n_events, p=w / w.sum())
    rows = rs.randint(0, m, n_events)
    vals = rs.randint(1, 6, n_events).astype(np.float32)
    return rows, cols, vals, (m, n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kw", [
    ("chunked", dict(event_chunk=997)),
    ("tiled", dict(event_chunk=1024, tile=8)),
    ("split", dict(head_items=64, event_chunk=1024, tile=8,
                   head_block_rows=128)),
    ("split", dict(head_items=300, head_block_rows=128)),
])
def test_streaming_operators_on_the_card_equal_the_cpu(kind, kw):
    """Integer events and integer panels: every f32 sum is exact, so each
    streaming operator's ``mm``/``rmm`` on the card equals its CPU result
    bit for bit, two calls on the card give the same bits, and the int8
    head built on the card equals the CPU head."""
    from polara_tpu_torch.ops import sparse as ts
    device = _cuda()
    rows, cols, vals, shape = _stream_events()
    make = getattr(ts, f"{kind}_coo_operator")
    cpu = make(rows, cols, vals, shape, device="cpu", **kw)
    card = make(rows, cols, vals, shape, device=device, **kw)
    rs = np.random.RandomState(3)
    x = torch.as_tensor(rs.randint(-3, 4, (shape[1], 100)),
                        dtype=torch.float32)
    y = torch.as_tensor(rs.randint(-3, 4, (shape[0], 100)),
                        dtype=torch.float32)
    for fn in ("mm", "rmm"):
        arg = x if fn == "mm" else y
        first = getattr(card, fn)(arg.to(device))
        assert torch.equal(first, getattr(card, fn)(arg.to(device)))
        assert torch.equal(first.cpu(), getattr(cpu, fn)(arg))
    if kind == "split":
        (d_card, ids_card), (d_cpu, ids_cpu) = (card.operands[0],
                                                cpu.operands[0])
        assert d_card.dtype == torch.int8
        assert torch.equal(d_card.cpu(), d_cpu)
        assert torch.equal(ids_card.cpu(), ids_cpu)


@pytest.mark.cuda
def test_streaming_builds_on_the_card_are_bit_identical():
    """Two Krylov builds through the split operator on the card give the
    same bits (the cuBLAS head product keeps its summation order), and
    the distributed build on a (4, 1) mesh of the card spans the
    single-device one (the same start and steps, other f32 order: a sine
    of 3.4e-6 on the CPU)."""
    from polara_tpu_torch.ops import sparse as ts
    from polara_tpu_torch.ops.rsvd import (principal_angles_max_sin,
                                           randomized_svd,
                                           randomized_svd_krylov)
    from polara_tpu_torch.parallel import distributed_chunked_rsvd
    from polara_tpu_torch.runtime.mesh import make_mesh
    device = _cuda()
    rows, cols, vals, shape = _stream_events()
    op = ts.split_coo_operator(rows, cols, vals, shape, head_items=64,
                               event_chunk=1024, tile=8, device=device)
    first = randomized_svd_krylov(op, 8, depth=3, seed=0)
    second = randomized_svd_krylov(op, 8, depth=3, seed=0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    mesh = make_mesh(devices=[device] * 4, shape=(4, 1))
    meshed = distributed_chunked_rsvd(rows, cols, vals, shape, 8, mesh,
                                      n_iter=20, seed=0, split_head=True,
                                      head_items=64, head_block_rows=128,
                                      event_chunk=997)
    single = randomized_svd(op, 8, n_iter=20, tol=None, seed=0,
                            qr_method="cholesky2")
    np.testing.assert_allclose(meshed.s.cpu().numpy(),
                               single.s.cpu().numpy(), rtol=1e-4)
    # the sine in f64: in f32, sqrt(1 - cos²) bottoms out near 3e-4
    assert principal_angles_max_sin(meshed.v.double(),
                                    single.v.double()) < 1e-4


def _forced_sample(seed=5, n_users=300, n_items=2000, rank=16, unseen=64):
    """Integer factors and seen sets that leave every user exactly
    ``unseen`` items: the sample is forced, whichever stream draws it."""
    rs = np.random.RandomState(seed)
    u = rs.randint(-3, 4, (n_users, rank)).astype(np.float32)
    v = rs.randint(-3, 4, (n_items, rank)).astype(np.float32)
    mask = np.ones((n_users, n_items), bool)
    for r in range(n_users):
        mask[r, rs.choice(n_items, unseen, replace=False)] = False
    rows, cols = np.nonzero(mask)
    return u, v, rows, cols


@pytest.mark.cuda
def test_sampled_scores_and_inner_products_on_the_card_equal_the_cpu():
    from polara_tpu_torch.ops.samplers import sampled_scores
    from polara_tpu_torch.ops.sparse import inner_product_at
    from polara_tpu_torch.runtime.rng import generator_from_seed
    device = _cuda()
    u, v, rows, cols = _forced_sample()
    out = {}
    for where in ("cpu", device):
        out[str(where)] = sampled_scores(
            torch.as_tensor(u, device=where), torch.as_tensor(v, device=where),
            torch.as_tensor(rows), torch.as_tensor(cols),
            torch.ones(len(rows), dtype=torch.bool),
            generator_from_seed(0, where), 64, chunk_rows=128,
            return_items=True)
    (cpu_s, cpu_i), (card_s, card_i) = out["cpu"], out[str(device)]
    assert card_s.device.type == "cuda"
    assert torch.equal(torch.sort(card_i.cpu(), 1).values,
                       torch.sort(cpu_i, 1).values)
    assert torch.equal(torch.sort(card_s.cpu(), 1).values,
                       torch.sort(cpu_s, 1).values)
    ui = torch.arange(len(u))[:, None]
    whole = inner_product_at(torch.as_tensor(u, device=device),
                             torch.as_tensor(v, device=device), ui, cpu_i)
    assert torch.equal(whole.cpu(), inner_product_at(
        torch.as_tensor(u), torch.as_tensor(v), ui, cpu_i))
    assert torch.equal(whole, inner_product_at(
        torch.as_tensor(u, device=device), torch.as_tensor(v, device=device),
        ui, cpu_i, block_rows=37))


def _context_data():
    import pandas as pd
    from polara_tpu_torch.data import ItemPostFilteringData
    rs = np.random.RandomState(0)
    n_users, n_items = 400, 120
    genres = np.array(["action", "comedy", "drama", "noir"])
    item_genre = genres[rs.randint(0, len(genres), n_items)]
    rows = [(u, i, rs.randint(1, 6), item_genre[i]) for u in range(n_users)
            for i in rs.choice(n_items, rs.randint(5, 15), replace=False)]
    events = pd.DataFrame(rows, columns=["userid", "movieid", "rating",
                                         "genre"])
    mapping = pd.DataFrame({"movieid": np.arange(n_items),
                            "genre": item_genre})
    data = ItemPostFilteringData(events, "userid", "movieid", "rating",
                                 item_context_mapping={"genre": mapping},
                                 seed=0, verbose=False)
    data.holdout_size = 1
    data.test_ratio = 0.2
    data.prepare()
    return data


@pytest.mark.cuda
def test_contextual_scoring_on_the_card_equals_the_cpu():
    """Integer factors: the boosted scores are exact, so the card's ids
    equal the CPU's, and the boost keeps the model off the kernel."""
    from polara_tpu_torch.models import ItemPostFilteringMixin, SVDModel

    class ContextSVD(ItemPostFilteringMixin, SVDModel):
        pass

    device = _cuda()
    data = _context_data()
    n_items = len(data.get_entity_index("movieid"))
    rs = np.random.RandomState(1)
    factors = {"userid": None, "movieid": torch.as_tensor(
        rs.randint(-2, 3, (n_items, 8)), dtype=torch.float32),
        "singular_values": torch.ones(8)}
    recs = {}
    for where in ("cpu", device):
        model = ContextSVD(data, device=where)
        model.set_factors(factors)
        before = tf.fused_score_topk.launches
        recs[str(where)] = model.recommendations
        assert tf.fused_score_topk.launches == before
    np.testing.assert_array_equal(recs[str(device)], recs["cpu"])


@pytest.mark.cuda
def test_sampled_fold_in_is_bit_identical_on_the_card():
    from polara_tpu_torch.data import RecommenderData, SampledEvaluationMixin
    from polara_tpu_torch.datasets.synthetic import \
        make_synthetic_interactions
    from polara_tpu_torch.models import SVDModel
    from polara_tpu_torch.models.sampled import SampledEvaluationSVDMixin

    class Data(SampledEvaluationMixin, RecommenderData):
        pass

    class Model(SampledEvaluationSVDMixin, SVDModel):
        pass

    device = _cuda()
    events = make_synthetic_interactions(n_users=3000, n_items=500,
                                         n_events=60_000, seed=0)
    data = Data(events, "userid", "movieid", "rating", seed=0,
                verbose=False)
    data.warm_start = False
    data.holdout_size = 1
    data.prepare()
    data.unseen_items_num = 100
    model = Model(data, device=device)
    model.verbose = False
    model.rank = 20
    model.build()
    first, _, _ = model._test_user_factors()
    second, _, _ = model._test_user_factors()
    assert first.device.type == "cuda" and torch.equal(first, second)
    recs = model.recommendations
    model._recommendations = None
    np.testing.assert_array_equal(model.recommendations, recs)


def _known_user_data(n_users=600, n_items=400, n_events=20_000):
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets.synthetic import \
        make_synthetic_interactions
    events = make_synthetic_interactions(n_users=n_users, n_items=n_items,
                                         n_events=n_events, seed=0)
    data = RecommenderData(events, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.warm_start = False
    data.holdout_size = 1
    data.prepare()
    return data


def _dyadic_factors(model, seed=2):
    rs = np.random.RandomState(seed)
    return {k: None if v is None else torch.as_tensor(
        np.clip(np.round(rs.randn(*v.shape) * 4) / 4, -2, 2),
        dtype=torch.float32) for k, v in model.factors.items()}


@pytest.mark.cuda
def test_rank_300_model_on_the_card_equals_the_cpu():
    """PureSVD at rank 300 under the default route: the card walks the
    rank in slices (counted launch); with its factors made dyadic the
    picks equal the CPU's plain version, ties included."""
    from polara_tpu_torch.models import SVDModel
    device = _cuda()
    data = _known_user_data()
    model = SVDModel(data, device=device)
    model.verbose = False
    model.rank = 300
    model.build()
    factors = _dyadic_factors(model)
    model.set_factors(factors)
    before = tf.fused_score_topk.launches
    got = model.recommendations
    assert tf.fused_score_topk.launches > before
    plain = SVDModel(data, device="cpu")
    plain.verbose = False
    plain.rank = 300
    plain.set_factors(factors)
    saved = config_default("fused_scoring", True)
    try:
        want = plain.recommendations
    finally:
        config_default("fused_scoring", saved)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method,rank", [("WRMF", 8), ("BPRMF", 300)])
def test_mymedialite_on_the_card_equals_the_cpu(tmp_path, method, rank):
    """``MyMediaLiteWrapper`` through the fake CLI: the card launches the
    kernel (BPRMF at 301 columns: sliced) and picks what the CPU's plain
    version picks from the same folded factors, re-scored in f64 where
    they differ (f32 sums in another order)."""
    import _fake_mml
    from polara_tpu_torch.models.external import MyMediaLiteWrapper
    device = _cuda()
    data = _known_user_data()
    data.name = "cudadata"
    library = _fake_mml.install(tmp_path / "mml")
    picks = {}
    for where in (device, "cpu"):
        folder = tmp_path / str(where)
        folder.mkdir()
        model = MyMediaLiteWrapper(library, str(folder), method, data,
                                   device=where)
        model.verbose = False
        model.rank = rank
        model.build()
        saved = config_default("fused_scoring", True)
        try:
            before = tf.fused_score_topk.launches
            picks[str(where)] = model.recommendations
            launched = tf.fused_score_topk.launches - before
        finally:
            config_default("fused_scoring", saved)
        if where == device:
            assert launched > 0
            v = model.factors["movieid"].cpu()
        else:
            assert torch.equal(model.factors["movieid"], v)
            profiles, _ = model.get_test_matrix()
    got, want = picks[str(device)], picks["cpu"]
    scores = (profiles.double() @ v.double() @ v.double().T).numpy()
    for row in np.flatnonzero((got != want).any(axis=1)):
        s = scores[row]
        assert np.abs(s[got[row]] - s[want[row]]).max() <= \
            1e-5 * np.abs(s).max()


@pytest.mark.cuda
@pytest.mark.parametrize("adapter", ["lightfm", "turi"])
def test_lightfm_and_turi_on_the_card_equal_the_cpu(adapter):
    """The LightFM and Turi adapters through their fakes: the picks made
    on the card (seen-item masking and top-k on the device) equal the
    CPU's."""
    import pandas as pd
    device = _cuda()
    if adapter == "lightfm":
        import _fake_lightfm
        _fake_lightfm.install()
        from polara_tpu_torch.models.external import LightFMWrapper as cls
    else:
        import _fake_turicreate
        _fake_turicreate.install()
        from polara_tpu_torch.models.external import (
            TuriFactorizationRecommender as cls)
    data = _known_user_data(n_users=120, n_items=80, n_events=3000)
    rs = np.random.RandomState(1)
    features = pd.DataFrame(
        {"genres": [rs.choice(["a", "b", "c"], rs.randint(1, 3),
                              replace=False).tolist()
                    for _ in range(80)]}, index=pd.RangeIndex(80))
    kwargs = ({"item_features": features} if adapter == "lightfm" else {})
    picks = []
    for where in (device, "cpu"):
        model = cls(data, device=where, **kwargs)
        model.verbose = False
        picks.append(model.recommendations)
    np.testing.assert_array_equal(picks[0], picks[1])
