"""The fused kernel's item split (``polara_tpu_torch.ops.fused_topk``):
the split rule, the split dealing, and the plain version of the split and
merge (``split_merge_reference``) against the unsplit plain version and
the JAX package's kernel.

``item_splits`` is pure arithmetic, so its table runs here; the kernel
itself runs only on the card (``tests/test_torch_cuda.py``), where every
split count must give the unsplit ids and values bit for bit.  Factors
here are small integers: scores are exact in f32 and dense with ties, so
the merge's tie rule (an equal value keeps the lower column) decides many
picks and ids must match exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polara_tpu.ops import pallas as jpallas
from polara_tpu_torch.ops import fused_topk as tf

SMS = 132   # an H100's SMs


@pytest.mark.parametrize("name,n_users,n_tiles,per_sm,want", [
    ("main rank 50", 69_878, 84, 3, 1),          # 1,092 user blocks
    ("Netflix", 480_189, 139, 3, 1),
    ("rank 300, sliced", 69_878, 84, 3, 1),
    ("mesh shard", 17_470, 84, 3, 1),           # 273 blocks of 396 slots
    ("CoFFee, HybridSVD", 13_976, 84, 3, 1),    # 219 blocks
    ("serving batch", 1_024, 84, 3, 24),        # 16 blocks x 24 = 384
    ("sweep top rank", 3_494, 84, 1, 2),        # 55 blocks x 2 = 110
    ("one user", 1, 84, 3, 84),                 # capped at the tiles
    ("one tile", 1_024, 1, 3, 1),
    ("no valid column", 10, 0, 3, 1),
    ("no user", 0, 84, 3, 1),
    ("user blocks == slots", 64 * 396, 84, 3, 1),
    ("one block short of the slots", 64 * 395, 84, 3, 1),
    ("half the slots", 64 * 198, 84, 3, 2),
])
def test_item_splits_table(name, n_users, n_tiles, per_sm, want):
    got = tf.item_splits(n_users, n_tiles, per_sm, SMS)
    assert got == want, name
    assert 1 <= got <= max(1, n_tiles)
    user_blocks = -(-n_users // tf.USER_BLOCK)
    slots = per_sm * SMS
    if got > 1:
        # one wave, and one more split would not fit in it
        assert user_blocks * got <= slots
        assert got == n_tiles or user_blocks * (got + 1) > slots


@pytest.mark.parametrize("n_users", [1, 16, 63, 64, 65, 1_024, 3_494,
                                     30_000, 10 ** 6])
@pytest.mark.parametrize("n_tiles", [1, 2, 7, 84, 139])
@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_item_splits_bounds(n_users, n_tiles, per_sm):
    got = tf.item_splits(n_users, n_tiles, per_sm, SMS)
    user_blocks = -(-n_users // tf.USER_BLOCK)
    assert 1 <= got <= n_tiles
    assert got == 1 or user_blocks * got <= per_sm * SMS
    if user_blocks >= per_sm * SMS:
        assert got == 1


@pytest.mark.parametrize("n_valid,splits", [(1, 1), (128, 1), (129, 2),
                                            (950, 3), (950, 8), (10_677, 24),
                                            (10_677, 84), (0, 1)])
def test_split_columns_deal_tiles_in_order(n_valid, splits):
    ranges = tf.split_columns(n_valid, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == max(n_valid, 0)
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi == lo2 and lo % tf.ITEM_TILE == 0
    widths = [-(-(hi - lo) // tf.ITEM_TILE) for lo, hi in ranges]
    assert max(widths) - min(widths) <= 1 or n_valid == 0


@pytest.mark.parametrize("rank,n_valid,tiles", [(50, 10_677, 84),
                                                (256, 10_677, 84),
                                                (257, 10_677, 42),
                                                (300, 1_000, 4)])
def test_tiles_follow_the_kernel_of_the_rank(rank, n_valid, tiles):
    """Above STAGED_RANK the sliced kernel walks tiles of 256 items, so
    its panel scratch and its splits count those."""
    assert tf.item_tiles(n_valid, rank) == tiles
    assert tf.panel_columns(n_valid, rank) == tiles * tf.tile_items(rank)
    ranges = tf.split_columns(n_valid, tiles, rank)
    assert all(lo % tf.tile_items(rank) == 0 for lo, _ in ranges)


@pytest.mark.parametrize("splits", [0, 9, -1])
def test_split_count_out_of_range_raises(splits):
    proj = torch.zeros((4, 3))
    items = torch.zeros((950, 3))    # 8 tiles
    bits = torch.zeros((4, 30), dtype=torch.int32)
    with pytest.raises(ValueError, match="splits"):
        tf.fused_score_topk(proj, items, bits, 5, _splits=splits)
    with pytest.raises(ValueError, match="splits"):
        tf.split_merge_reference(proj, items, bits, 5, splits)


def _tied_case(seed, n_users, n_items, rank, n_valid):
    """Integer factors in {0, 1, 2}: few distinct scores, ties everywhere.
    Users 0 and 1 have seen every valid item but 5 and but 0 (fewer unseen
    items than k: PAD slots); the rest ~30% of the items."""
    rs = np.random.RandomState(seed)
    proj = rs.randint(0, 3, (n_users, rank)).astype(np.float32)
    items = rs.randint(0, 3, (n_items, rank)).astype(np.float32)
    seen = rs.rand(n_users, n_items) < 0.3
    seen[0, :n_valid] = True
    seen[0, rs.choice(n_valid, 5, replace=False)] = False
    seen[1, :n_valid] = True
    rows, cols = np.nonzero(seen)
    bits = tf.pack_seen_bits(torch.as_tensor(rows), torch.as_tensor(cols),
                             n_users, n_items)
    return torch.as_tensor(proj), torch.as_tensor(items), bits


@pytest.mark.parametrize("k", [1, 10, 33, 128])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, "n_tiles"])
def test_split_merge_equals_plain_with_ties(splits, k):
    n_valid = 950                                  # ragged: 8 tiles
    proj, items, bits = _tied_case(k, 40, 1000, 4, n_valid)
    if splits == "n_tiles":
        splits = tf.item_tiles(n_valid)
    want_vals, want_ids = tf.fused_score_topk_reference(
        proj, items, bits, k, n_valid_cols=n_valid, return_values=True)
    vals, ids = tf.split_merge_reference(proj, items, bits, k, splits,
                                         n_valid_cols=n_valid,
                                         return_values=True)
    assert torch.equal(ids, want_ids)
    assert torch.equal(vals, want_vals)
    assert (ids[1] == tf.PAD_CONST).all()          # saw every valid item
    assert (ids[0, 5:] == tf.PAD_CONST).all()


@pytest.mark.parametrize("k,splits", [(10, 3), (128, 8), (33, 2)])
def test_split_merge_equals_plain_seen_items_kept(k, splits):
    proj, items, bits = _tied_case(100 + k, 24, 1000, 3, 1000)
    want = tf.fused_score_topk_reference(proj, items, bits, k,
                                         filter_seen=False,
                                         return_values=True)
    got = tf.split_merge_reference(proj, items, bits, k, splits,
                                   filter_seen=False, return_values=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("k,splits", [(10, 2), (128, 4)])
def test_split_merge_equals_plain_at_a_sliced_rank(k, splits):
    """Rank 260 deals 256-item tiles (4 over 950 columns)."""
    proj, items, bits = _tied_case(200 + k, 16, 1000, 260, 950)
    want = tf.fused_score_topk_reference(proj, items, bits, k,
                                         n_valid_cols=950,
                                         return_values=True)
    got = tf.split_merge_reference(proj, items, bits, k, splits,
                                   n_valid_cols=950, return_values=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_split_merge_pads_past_a_small_catalog():
    proj, items, bits = _tied_case(3, 8, 300, 2, 300)      # 3 tiles
    vals, ids = tf.split_merge_reference(proj, items, bits, 128, 3,
                                         filter_seen=False,
                                         return_values=True)
    want_vals, want_ids = tf.fused_score_topk_reference(
        proj, items, bits, 128, filter_seen=False, return_values=True)
    assert torch.equal(ids, want_ids) and torch.equal(vals, want_vals)
    assert (ids[:, :128] >= 0).all()


def test_split_merge_matches_jax_kernel_interpret():
    """One shape also against the Pallas kernel in interpret mode (as
    ``tests/test_torch_fused_topk.py`` runs it): 3 splits of 8 tiles."""
    proj, items, bits = _tied_case(11, 33, 1000, 6, 1000)
    rows, cols = np.nonzero(tf.seen_mask(bits, 1000).numpy())
    jbits = jpallas.pack_seen_bits(rows.astype(np.int32),
                                   cols.astype(np.int32), 33, 1000)
    jvals, jidx = jpallas.fused_score_topk(
        jnp.asarray(proj.numpy()), jnp.asarray(items.numpy()),
        jnp.asarray(jbits), 20, interpret=True, return_values=True)
    vals, ids = tf.split_merge_reference(proj, items, bits, 20, 3,
                                         return_values=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_cpu_wrapper_with_pinned_splits_is_the_plain_version():
    proj, items, bits = _tied_case(5, 40, 1000, 4, 1000)
    before = tf.fused_score_topk.launches
    got = tf.fused_score_topk(proj, items, bits, 10, _splits=8,
                              return_values=True)
    want = tf.fused_score_topk_reference(proj, items, bits, 10,
                                         return_values=True)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert tf.fused_score_topk.launches == before
