"""Static chunk planning against a device-memory budget.

Copy of :mod:`polara_tpu.runtime.memory`'s planner with the same budget
semantics (``hbm_score_budget_gb`` caps one dense score block), so both
packages cut the test users into identical chunks.
"""
from __future__ import annotations

from typing import List, Tuple

from polara_tpu_torch.config import get_default

_SUBLANE = 8


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def range_division(total: int, chunk: int) -> List[int]:
    """Split points covering ``[0, total]`` in steps of ``chunk``."""
    bounds = list(range(0, total, chunk)) + [total]
    if bounds[-2] == bounds[-1]:
        bounds.pop()
    return bounds


def plan_user_chunks(n_users: int, n_items: int,
                     scores_multiplier: int = 1,
                     itemsize: int = 4,
                     budget_gb: float | None = None,
                     max_chunk: int | None = None,
                     n_shards: int = 1,
                     n_devices: int | None = None) -> List[Tuple[int, int]]:
    """Plan (start, stop) user slices whose dense score block fits the budget.

    ``scores_multiplier`` inflates the estimate for models whose scores
    carry an extra axis; ``n_shards`` aligns chunk sizes for a row-sharded
    score block, and the budget scales by ``n_devices``, the distinct
    devices its shards lie on (default ``n_shards``, as in the JAX
    package, where every shard is a device of its own).
    """
    budget = (budget_gb if budget_gb is not None
              else get_default("hbm_score_budget_gb")) * (1024 ** 3)
    budget *= max(int(n_shards if n_devices is None else n_devices), 1)
    row_bytes = n_items * scores_multiplier * itemsize
    chunk = int(budget // max(row_bytes, 1))
    if chunk <= 0:
        raise MemoryError(
            f"A single score row ({row_bytes} bytes) exceeds the device "
            "memory budget; raise hbm_score_budget_gb.")
    chunk = min(chunk, n_users)
    if max_chunk is not None:
        chunk = min(chunk, max_chunk)
    align = _SUBLANE * max(int(n_shards), 1)
    chunk = max(align, round_up(chunk, align) if chunk >= align else chunk)
    bounds = range_division(n_users, chunk)
    return list(zip(bounds[:-1], bounds[1:]))
