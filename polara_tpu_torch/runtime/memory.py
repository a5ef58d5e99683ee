"""Static chunk planning against a device-memory budget.

Copy of :mod:`polara_tpu.runtime.memory`: the planner with the same budget
semantics (``hbm_score_budget_gb`` caps one dense score block), so both
packages cut the test users into identical chunks, and the reference's
helpers around it (``pad_dim``, ``read_npz_from_url``,
``get_available_memory``, ``get_chunk_size``, ``array_split``).
"""
from __future__ import annotations

from typing import List, Tuple

from polara_tpu_torch.config import get_default

_LANE = 128
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


def pad_dim(n: int, lane_align: bool = True) -> int:
    """Pad a trailing dimension to a multiple of 128 (or of 8 with
    ``lane_align=False``), the JAX package's tile grid."""
    return round_up(max(n, 1), _LANE if lane_align else _SUBLANE)


def read_npz_from_url(url: str):
    """Load an npz archive from a URL (reference
    ``polara/recommender/utils.py:56-60``); ``file://`` URLs read local
    files, other schemes need network access."""
    import io
    from urllib.request import urlopen

    import numpy as np
    with urlopen(url) as response:
        return np.load(io.BytesIO(response.read()))


def get_available_memory() -> float:
    """Available host RAM in bytes (reference
    ``polara/tools/systools.py:13-57``): psutil when present, else
    ``/proc/meminfo``.  Device memory is ``torch.cuda.mem_get_info``'s."""
    try:
        import psutil
        return float(psutil.virtual_memory().available)
    except ImportError:
        pass
    try:
        with open("/proc/meminfo") as handle:
            for line in handle:
                if line.startswith("MemAvailable:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    raise RuntimeError("cannot determine available memory on this platform")


def get_chunk_size(n_rows: int, n_cols: int, scores_multiplier: int = 1,
                   budget_gb: float | None = None) -> int:
    """Largest row chunk whose dense score block fits the budget
    (reference ``polara/recommender/utils.py:16-47``), from the static
    planner."""
    bounds = plan_user_chunks(n_rows, n_cols,
                              scores_multiplier=scores_multiplier,
                              budget_gb=budget_gb)
    return bounds[0][1] - bounds[0][0]


def array_split(n_rows: int, n_cols: int, scores_multiplier: int = 1,
                budget_gb: float | None = None) -> List[int]:
    """Chunk bounds like the reference's ``array_split``
    (``utils.py:50-53``): ``[0, c, 2c, ..., n_rows]``."""
    chunk = get_chunk_size(n_rows, n_cols,
                           scores_multiplier=scores_multiplier,
                           budget_gb=budget_gb)
    return range_division(n_rows, chunk)
