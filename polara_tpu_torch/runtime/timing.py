"""Wall-clock timing helpers (counterpart of
:mod:`polara_tpu.runtime.timing`).

PyTorch returns from a CUDA call before the device finishes, so
:func:`track_time` and :func:`timed_blocked` synchronise every visible
card before they read the clock, at both ends.  :func:`profiler_trace` records a
``torch.profiler`` trace of a block.
"""
from __future__ import annotations

import os
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
    """Wait for every visible card once CUDA is initialized: a result may
    live on any card of a mesh, not only the current one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for index in range(torch.cuda.device_count()):
            torch.cuda.synchronize(index)


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


def timed_blocked(fn, *args, **kwargs):
    """Run ``fn`` and wait for the device's queued work; return
    ``(result, seconds)``."""
    _sync()
    start = time.perf_counter()
    result = fn(*args, **kwargs)
    _sync()
    return result, time.perf_counter() - start


@contextmanager
def profiler_trace(logdir: Optional[str] = None):
    """Optionally record a ``torch.profiler`` trace of a block (the CPU,
    and the card when one is in use) into ``logdir/trace.json`` (Chrome
    trace format).  Yields the profiler (None without ``logdir``), whose
    ``key_averages()`` summarise the block."""
    if logdir is None:
        yield None
        return
    import torch.profiler as tp
    activities = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(tp.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tp.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_compilation_cache(cache_dir: Optional[str] = None) -> None:
    """Name-parity no-op: the JAX package persists XLA executables here.
    The port's one compiled artifact, the CUDA kernel library, is already
    cached by content hash in the package's ``_build/`` directory, and
    the rest of the port runs eagerly, so there is nothing to enable."""
    return None
