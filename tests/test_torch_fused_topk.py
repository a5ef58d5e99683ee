"""The fused score/mask/top-k route of the port
(``polara_tpu_torch.ops.fused_topk``) against the JAX package.

On the CPU the port's wrapper runs its plain version.  It is held to the
Pallas kernel in interpret mode on a few small one- and two-tile cases,
and to JAX's unfused ``mask_and_topk`` (which ``tests/test_pallas.py``
proves equal to the kernel) on the rest of the kernel test shapes.

Factors are dyadic (multiples of 1/4 in [-2, 2]): every product and every
partial sum over rank <= 50 is exact in f32, so the two packages' scores
agree bit for bit whatever order their matmuls sum in, and ids — ties
included — must match exactly.  Values are held to 1e-6 relative.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polara_tpu.ops import pallas as jpallas
from polara_tpu.ops.topk import mask_and_topk as jax_mask_and_topk
from polara_tpu_torch.ops import fused_topk as tf


def _dyadic(rs, shape):
    return np.clip(np.round(rs.randn(*shape) * 4) / 4, -2, 2).astype(
        np.float32)


def _case(seed, n_users, n_items, rank, nnz, integer=False):
    rs = np.random.RandomState(seed)
    if integer:
        proj = rs.randint(0, 3, (n_users, rank)).astype(np.float32)
        items = rs.randint(0, 4, (n_items, rank)).astype(np.float32)
    else:
        proj = _dyadic(rs, (n_users, rank))
        items = _dyadic(rs, (n_items, rank))
    pairs = np.unique(np.stack([rs.randint(0, n_users, nnz),
                                rs.randint(0, n_items, nnz)], 1), axis=0) \
        if nnz else np.zeros((0, 2), np.int64)
    return proj, items, pairs[:, 0].astype(np.int32), \
        pairs[:, 1].astype(np.int32)


def _port(proj, items, rows, cols, k, **kwargs):
    bits = tf.pack_seen_bits(torch.as_tensor(rows), torch.as_tensor(cols),
                             proj.shape[0], items.shape[0])
    return tf.fused_score_topk(torch.as_tensor(proj), torch.as_tensor(items),
                               bits, k, **kwargs)


def _jax_unfused(proj, items, rows, cols, k, filter_seen=True,
                 n_valid=None):
    return np.asarray(jax_mask_and_topk(
        jnp.asarray(proj) @ jnp.asarray(items).T, jnp.asarray(rows),
        jnp.asarray(cols), jnp.ones(len(rows), bool), k,
        filter_seen=filter_seen,
        n_valid_cols=n_valid if n_valid is not None else items.shape[0]))


@pytest.mark.parametrize("seed,n_users,n_items,rank,k,nnz,filter_seen", [
    (10, 8, 100, 4, 10, 50, True),        # one tile
    (0, 16, 700, 12, 10, 300, False),     # one tile, seen items kept
    (11, 33, 5000, 16, 20, 4000, True),   # two tiles, odd user count
])
def test_plain_matches_jax_kernel_interpret(seed, n_users, n_items, rank, k,
                                            nnz, filter_seen):
    proj, items, rows, cols = _case(seed, n_users, n_items, rank, nnz)
    jbits = jpallas.pack_seen_bits(rows, cols, n_users, n_items)
    jvals, jidx = jpallas.fused_score_topk(
        jnp.asarray(proj), jnp.asarray(items), jnp.asarray(jbits), k,
        filter_seen=filter_seen, interpret=True, return_values=True)
    tvals, tidx = _port(proj, items, rows, cols, k, filter_seen=filter_seen,
                        return_values=True)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=1e-6)


@pytest.mark.parametrize("filter_seen", [True, False])
@pytest.mark.parametrize("tile_skip", [False, True])
def test_parity_with_jax_unfused(filter_seen, tile_skip):
    proj, items, rows, cols = _case(0, 16, 700, 12, 300)
    got = _port(proj, items, rows, cols, 10, filter_seen=filter_seen,
                tile_skip=tile_skip)
    np.testing.assert_array_equal(
        got.numpy(), _jax_unfused(proj, items, rows, cols, 10,
                                  filter_seen=filter_seen))


@pytest.mark.parametrize("seed,n_users,n_items,rank,k,nnz", [
    (10, 8, 100, 4, 10, 50),         # tiny catalog
    (11, 33, 5000, 16, 20, 4000),    # odd user count
    (12, 130, 9000, 8, 1, 20_000),   # k=1
    (13, 16, 4096, 8, 128, 1000),    # k == MAX_K
    (14, 24, 300, 5, 7, 24 * 250),   # dense seen sets (~83% seen)
    (2, 40, 700, 12, 5, 500),        # several user blocks
])
def test_kernel_shapes_match_jax_unfused(seed, n_users, n_items, rank, k,
                                         nnz):
    proj, items, rows, cols = _case(seed, n_users, n_items, rank, nnz)
    got = _port(proj, items, rows, cols, k)
    np.testing.assert_array_equal(
        got.numpy(), _jax_unfused(proj, items, rows, cols, k))


def test_integer_ties_resolve_to_lowest_column():
    proj, items, rows, cols = _case(7, 12, 1000, 1, 600, integer=True)
    got = _port(proj, items, rows, cols, 16)
    np.testing.assert_array_equal(
        got.numpy(), _jax_unfused(proj, items, rows, cols, 16))


def test_duplicate_scores_across_tiles():
    n_users, n_items = 8, 512
    proj = np.ones((n_users, 1), np.float32)
    items = np.tile([3.0, 1.0, 2.0, 2.0], n_items // 4)[:, None].astype(
        np.float32)
    none = np.zeros(0, np.int32)
    got = _port(proj, items, none, none, 7, filter_seen=False,
                tile_skip=True)
    np.testing.assert_array_equal(
        got.numpy(), _jax_unfused(proj, items, none, none, 7,
                                  filter_seen=False))


def test_pad_beyond_catalog():
    proj, items, _, _ = _case(1, 16, 35, 12, 0)
    vals, got = _port(proj, items, np.zeros(0, np.int32),
                      np.zeros(0, np.int32), 40, filter_seen=False,
                      n_valid_cols=35, return_values=True)
    assert (got[:, 35:] == tf.PAD_CONST).all()
    assert torch.isinf(vals[:, 35:]).all()
    order = np.argsort(-(proj @ items.T), axis=1, kind="stable")
    np.testing.assert_array_equal(got[:, :35].numpy(), order)


def test_k_guard():
    proj, items, _, _ = _case(3, 4, 50, 4, 0)
    bits = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="k <="):
        tf.fused_score_topk(torch.as_tensor(proj), torch.as_tensor(items),
                            bits, tf.MAX_K + 1)


def test_pack_seen_bits_layout_and_clear():
    rs = np.random.RandomState(4)
    n_rows, n_cols, nnz = 30, 9000, 1200
    flat = rs.choice(n_rows * n_cols, nnz, replace=False)
    flat[:3] = [31, 63, n_cols + 95]        # bit 31 (the int32 sign bit)
    rows, cols = flat // n_cols, flat % n_cols
    bits = tf.pack_seen_bits(torch.as_tensor(rows), torch.as_tensor(cols),
                             n_rows, n_cols)
    assert bits.dtype == torch.int32 and bits.shape == (n_rows, 282)
    words = bits.numpy().view(np.uint32)
    assert all((words[r, c // 32] >> (c % 32)) & 1 for r, c in zip(rows, cols))
    assert np.unpackbits(words.view(np.uint8)).sum() == nnz
    dense = tf.seen_mask(bits, n_cols).numpy()
    assert dense.sum() == nnz and dense[rows, cols].all()
    drop = rs.choice(nnz, 100, replace=False)
    keep = np.setdiff1d(np.arange(nnz), drop)
    cleared = tf.clear_seen_bits(bits, torch.as_tensor(rows[drop]),
                                 torch.as_tensor(cols[drop]))
    want = tf.pack_seen_bits(torch.as_tensor(rows[keep]),
                             torch.as_tensor(cols[keep]), n_rows, n_cols)
    assert torch.equal(cleared, want)


@pytest.mark.parametrize("n_valid,want", [(0, 0), (1, 128), (128, 128),
                                          (129, 256), (10_677, 10_752),
                                          (-5, 0)])
def test_panel_scratch_covers_whole_tiles(n_valid, want):
    assert tf.panel_columns(n_valid) == want


def test_ptxas_report_reads_registers_and_spills():
    from polara_tpu_torch.ops._cuda_build import ptxas_report
    log = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117score_topk_kernelILi1EEEvPKfS2_iPKiPfPiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117score_topk_kernelILi1EEEvPKfS2_iPKiPfPiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122transpose_panel_kernelEPKfPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122transpose_panel_kernelEPKfPfiii
    8 bytes stack frame, 12 bytes spill stores, 260 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 4224 bytes smem
"""
    report = ptxas_report(log)
    assert report == {
        "_ZN12_GLOBAL__N_117score_topk_kernelILi1EEEvPKfS2_iPKiPfPiiiiiii":
            {"spill_stores": 0, "spill_loads": 0, "registers": 80},
        "_ZN12_GLOBAL__N_122transpose_panel_kernelEPKfPfiii":
            {"spill_stores": 12, "spill_loads": 260, "registers": 30}}
    assert ptxas_report("") == {}


def test_variant_builds_get_their_own_library():
    from polara_tpu_torch.ops._cuda_build import library_path
    plain = library_path()
    variant = library_path(("POLARA_PHASE_NO_SELECTION",))
    assert plain == library_path() and variant != plain
    assert variant.parent == plain.parent


def test_cpu_wrapper_does_not_count_launches():
    before = tf.fused_score_topk.launches
    proj, items, rows, cols = _case(10, 8, 100, 4, 50)
    _port(proj, items, rows, cols, 10)
    assert tf.fused_score_topk.launches == before


def test_duplicate_pair_sets_its_bit_once_like_the_jax_plan():
    """A (row 0, item 3) pair given twice sets bit 3 once, as the JAX plan
    ORs it (``ChunkedTestData.build`` of both packages; the JAX plan's
    words at ``tile_n=32`` are the natural layout): no carry into item 4,
    and item 3 stays masked."""
    from polara_tpu.ops.scoring import ChunkedTestData as JaxPlan
    from polara_tpu_torch.ops.scoring import ChunkedTestData as TorchPlan
    rows = np.array([0, 0, 0, 1, 2, 2])
    cols = np.array([3, 3, 35, 0, 7, 39])
    vals = np.ones(len(rows))
    want = np.asarray(JaxPlan.build(rows, cols, vals, 3, 40).seen_bits(
        0, 40, tile_n=32))[:3]
    got = TorchPlan.build(rows, cols, vals, 3, 40, device="cpu").seen_bits(
        0, 40)[:3]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert want[0, 0] == 8
    mask = tf.seen_mask(got, 40)
    assert mask[0, 3] and not mask[0, 4]
