"""Operation and byte counts from shapes, and the card's published peaks.

Counts are of the work an algorithm needs, not of what a given
implementation runs: each input byte read once, each output byte written
once, one multiply-add as two operations.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense rates at the 700 W power limit
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12        # HBM3 bytes per second


def topk_flops(n_users: int, n_items: int, rank: int) -> float:
    """The fused kernel's least work: one multiply-add per (user, item,
    rank step)."""
    return 2.0 * n_users * n_items * rank


def topk_bytes(n_users: int, n_items: int, rank: int, k: int) -> float:
    """Its least traffic in f32/int32 words: the user panel, the item
    panel and the packed seen bits read once, k ids and values written."""
    words = n_users * rank + n_items * rank + n_users * -(-n_items // 32) \
        + 2 * n_users * k
    return 4.0 * words


def topk_least_seconds(n_users: int, n_items: int, rank: int, k: int
                       ) -> float:
    """The least time the card could take for one call: the larger of the
    operations at the f32 peak and the bytes at the HBM peak."""
    return max(topk_flops(n_users, n_items, rank) / PEAK_F32_FLOPS,
               topk_bytes(n_users, n_items, rank, k) / PEAK_HBM_BYTES)


def projection_flops(nnz: int, rank: int) -> float:
    """``r_u V`` for every test user: a multiply-add per event and rank
    step."""
    return 2.0 * nnz * rank


def householder_qr_flops(rows: int, cols: int) -> float:
    """Householder QR of a tall (rows x cols) panel with the explicit
    thin Q: 2mn² - 2n³/3 for R and as much again to form Q."""
    return 2.0 * (2.0 * rows * cols ** 2 - 2.0 * cols ** 3 / 3.0)


def rsvd_fixed_flops(m: int, n: int, rank: int, iters: int,
                     oversample: int | None = None) -> float:
    """Randomized subspace iteration at a fixed count (Halko et al.): a
    start ``A Ω``, ``iters`` two-sided power steps ``Aᵀ Q`` and ``A Z``
    each followed by a QR, and the Rayleigh-Ritz product ``Qᵀ A`` with
    the SVD of its (b x n) result; b = rank + max(10, rank)."""
    b = rank + (oversample if oversample is not None else max(10, rank))
    product = 2.0 * m * n * b
    products = (1 + 2 * iters + 1) * product
    qrs = householder_qr_flops(m, b) * (1 + iters) \
        + householder_qr_flops(n, b) * iters
    small_svd = 4.0 * n * b * b + 22.0 * b ** 3
    return products + qrs + small_svd


def ials_direct_flops(n_users: int, n_items: int, nnz: int, rank: int,
                      epochs: int) -> float:
    """Implicit ALS by Hu, Koren and Volinsky's direct solve: per
    half-sweep the Gram of the fixed side, a rank-one update and a
    right-hand-side term per event, and a Cholesky solve per entity."""
    k = rank

    def half(n_solved: int, n_fixed: int) -> float:
        gram = 2.0 * n_fixed * k * k
        per_event = nnz * (2.0 * k * k + 2.0 * k)
        solves = n_solved * (k ** 3 / 3.0 + 2.0 * k * k)
        return gram + per_event + solves

    return epochs * (half(n_users, n_items) + half(n_items, n_users))
