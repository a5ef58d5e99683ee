"""Operation and byte counts at the main shape."""
import pytest

from portbench import work

USERS, ITEMS, RANK, K = 69_878, 10_677, 50, 10


def test_kernel_operations_at_the_main_shape():
    # 74.6 GFLOP, as the kernel table of PERF.md states
    assert work.topk_flops(USERS, ITEMS, RANK) == pytest.approx(74.61e9,
                                                              rel=1e-3)


def test_kernel_bytes_and_least_time():
    words = USERS * RANK + ITEMS * RANK + USERS * 334 + 2 * USERS * K
    assert work.topk_bytes(USERS, ITEMS, RANK, K) == 4 * words
    # compute-bound: 74.6 GFLOP at 67 TFLOP/s is 1.114 ms, the bytes
    # (~0.11 GB) 0.03 ms
    assert work.topk_least_seconds(USERS, ITEMS, RANK, K) == \
        pytest.approx(1.1136e-3, rel=1e-3)


def test_fixed_randomized_svd_work():
    # 18 products of 2·m·n·100 (start, 8 two-sided steps, Rayleigh-Ritz)
    products = 18 * 2 * USERS * ITEMS * 100
    total = work.rsvd_fixed_flops(USERS, ITEMS, RANK, 8)
    assert products < total < 1.1 * products
    assert total == pytest.approx(2.71e12, rel=0.01)


def test_direct_ials_work():
    total = work.ials_direct_flops(USERS, ITEMS, 9_930_176, RANK, 15)
    per_event = 15 * 2 * 9_930_176 * (2 * RANK ** 2 + 2 * RANK)
    assert per_event < total < 1.1 * per_event
    assert total == pytest.approx(1.6e12, rel=0.05)


def test_qr_work():
    assert work.householder_qr_flops(1000, 10) == pytest.approx(
        2 * (2 * 1000 * 100 - 2 * 1000 / 3))
