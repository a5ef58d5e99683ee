"""Wall-clock timing helpers (counterpart of
:mod:`polara_tpu.runtime.timing`).

PyTorch returns from a CUDA call before the device finishes, so
:func:`track_time` synchronises the device before it reads the clock, at
both ends of the block.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import List, Optional

import torch


def format_elapsed_time(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}µs"
    if seconds < 1:
        return f"{seconds * 1e3:.1f}ms"
    if seconds < 60:
        return f"{seconds:.3f}s"
    minutes, secs = divmod(seconds, 60)
    return f"{int(minutes)}m{secs:04.1f}s"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def track_time(store: Optional[List[float]] = None, verbose: bool = False,
               model: str = "", label: str = "training"):
    """Context manager appending elapsed seconds to ``store``; CUDA work
    queued inside the block is waited for before the clock stops."""
    _sync()
    start = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        elapsed = time.perf_counter() - start
        if store is not None:
            store.append(elapsed)
        if verbose:
            name = f"{model} " if model else ""
            print(f"{name}{label} time: {format_elapsed_time(elapsed)}")
