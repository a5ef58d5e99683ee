"""Native host-kernel bindings (C++ via ctypes, numpy fallbacks).

Counterpart of :mod:`polara_tpu.native` with its own copy of the C++
source (``host_kernels.cpp``, same C interface).  ``g++`` compiles it at
first use into the gitignored ``polara_tpu_torch/_build/``, never beside
the source; the file name carries a hash of the source and flags, so an
edited source builds anew.  Every entry point keeps the JAX package's
numpy fallback for a machine without a compiler.  This is host code: it
runs no device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "host_kernels.cpp"
BUILD_DIR = _SOURCE.parent.parent / "_build"
_FLAG_SETS = (["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp"],
              ["-O3", "-std=c++17", "-shared", "-fPIC"])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
build_error = ""   # the compiler's output when no flag set built


def library_path(flags: List[str]) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(_SOURCE.read_bytes())
    return BUILD_DIR / f"libpolara_host_{digest.hexdigest()[:16]}.so"


def _compile() -> Optional[Path]:
    """Build the library (with OpenMP if the compiler has it) unless a
    build for this source exists; None if no flag set builds."""
    global build_error
    for flags in _FLAG_SETS:
        target = library_path(flags)
        if target.exists():
            return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for flags in _FLAG_SETS:
        target = library_path(flags)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                proc = subprocess.run(["g++", *flags, str(_SOURCE), "-o", tmp],
                                      capture_output=True, text=True,
                                      timeout=240)
            except (OSError, subprocess.TimeoutExpired) as exc:
                build_error = str(exc)
                return None
            if proc.returncode == 0:
                os.replace(tmp, target)   # atomic: concurrent builders agree
                return target
            build_error = proc.stdout + proc.stderr
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed, build_error
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _compile()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            build_error = str(exc)
            _build_failed = True
            return None

        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.build_indptr.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                     i64p]
        lib.build_indptr.restype = None
        lib.sample_unseen_rows.argtypes = [
            i64p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, i32p]
        lib.sample_unseen_rows.restype = ctypes.c_int
        lib.split_top_continuous.argtypes = [i64p, f64p, ctypes.c_int64,
                                             i64p, i64p, i64p, i64p]
        lib.split_top_continuous.restype = None
        lib.row_unique_counts.argtypes = [i32p, i32p, ctypes.c_int64,
                                          ctypes.c_int32, i64p]
        lib.row_unique_counts.restype = None
        lib.pack_seen_bits.argtypes = [i32p, i32p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, u32p]
        lib.pack_seen_bits.restype = None
        lib.group_top_k.argtypes = [i32p, f64p, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32,
                                    i64p, i64p]
        lib.group_top_k.restype = None
        _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _as_ptr(array: np.ndarray, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


def build_indptr(rows: np.ndarray, n_rows: int) -> np.ndarray:
    """CSR row pointers from row-sorted COO row ids."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lib = get_lib()
    if lib is None:
        counts = np.bincount(rows, minlength=n_rows)
        return np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    indptr = np.empty(n_rows + 1, dtype=np.int64)
    lib.build_indptr(_as_ptr(rows, ctypes.c_int32), len(rows), n_rows,
                     _as_ptr(indptr, ctypes.c_int64))
    return indptr


def sample_unseen_rows(indptr: np.ndarray, indices: np.ndarray,
                       n_cols: int, k: int,
                       seed: Optional[int] = 0) -> np.ndarray:
    """For every CSR row, draw ``k`` uniform samples from the unseen
    columns (without replacement).

    RNG note: the native path seeds an independent mt19937_64 per row
    while the numpy fallback draws from a single RandomState, so for the
    same seed the two paths return different (equally valid) samples.
    """
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n_rows = len(indptr) - 1
    lib = get_lib()
    if lib is None:
        rs = np.random.RandomState(seed)
        out = np.empty((n_rows, k), dtype=np.int32)
        for r in range(n_rows):
            seen = indices[indptr[r]:indptr[r + 1]]
            if n_cols - len(seen) < k:
                raise ValueError("some rows have fewer unseen columns "
                                 "than requested samples")
            keys = rs.rand(n_cols)
            keys[seen] = -1.0
            out[r] = np.argpartition(keys, -k)[-k:].astype(np.int32)
        return out
    out = np.empty((n_rows, k), dtype=np.int32)
    status = lib.sample_unseen_rows(
        _as_ptr(indptr, ctypes.c_int64), _as_ptr(indices, ctypes.c_int32),
        n_rows, n_cols, k, 0 if seed is None else int(seed),
        _as_ptr(out, ctypes.c_int32))
    if status != 0:
        raise ValueError("some rows have fewer unseen columns than "
                         "requested samples")
    return out


def split_top_continuous(tasks: np.ndarray, priorities: np.ndarray
                         ) -> Tuple[List[int], List[int], List[int]]:
    """Temporal split guard (reference ``polara/lib/sampler.py:135-165``):
    ``(top, low, nonseq)`` event indices.  Raises without the library."""
    tasks = np.ascontiguousarray(tasks, dtype=np.int64)
    priorities = np.ascontiguousarray(priorities, dtype=np.float64)
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(tasks)
    top = np.empty(n, dtype=np.int64)
    low = np.empty(n, dtype=np.int64)
    nonseq = np.empty(n, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)
    lib.split_top_continuous(
        _as_ptr(tasks, ctypes.c_int64), _as_ptr(priorities, ctypes.c_double),
        n, _as_ptr(top, ctypes.c_int64), _as_ptr(low, ctypes.c_int64),
        _as_ptr(nonseq, ctypes.c_int64), _as_ptr(counts, ctypes.c_int64))
    return (top[:counts[0]].tolist(), low[:counts[1]].tolist(),
            nonseq[:counts[2]].tolist())


def row_unique_counts(rows: np.ndarray, cols: np.ndarray,
                      n_rows: int) -> np.ndarray:
    """Distinct-column counts per row of row-sorted events."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    lib = get_lib()
    if lib is None:
        import pandas as pd
        counts = (pd.DataFrame({"r": rows, "c": cols})
                  .groupby("r")["c"].nunique())
        out = np.zeros(n_rows, dtype=np.int64)
        out[counts.index.values] = counts.values
        return out
    out = np.empty(n_rows, dtype=np.int64)
    lib.row_unique_counts(_as_ptr(rows, ctypes.c_int32),
                          _as_ptr(cols, ctypes.c_int32), len(rows), n_rows,
                          _as_ptr(out, ctypes.c_int64))
    return out


def pack_seen_bits(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                   n_cols: int, tile_n: int = 4096) -> Optional[np.ndarray]:
    """Striped bitmask packing of the JAX package's Pallas layout (tile of
    ``tile_n`` columns, offset o in word o % W at bit o // W); None when
    the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    w = tile_n // 32
    n_tiles = max(1, -(-n_cols // tile_n))
    out = np.zeros((n_rows, n_tiles * w), dtype=np.uint32)
    lib.pack_seen_bits(_as_ptr(rows, ctypes.c_int32),
                       _as_ptr(cols, ctypes.c_int32), len(rows), n_rows,
                       tile_n, n_tiles * w,
                       _as_ptr(out, ctypes.c_uint32))
    return out


def group_top_k(groups: np.ndarray, values: np.ndarray, n_groups: int,
                k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group top-k event selection (the scale path for holdout
    sampling).  Returns (event indices, per-group counts); among ties the
    later event wins (pandas ``nlargest(keep='last')``).  Falls back to a
    numpy sort when the library is unavailable."""
    groups = np.ascontiguousarray(groups, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    if k <= 0:
        return (np.empty(0, dtype=np.int64),
                np.zeros(n_groups, dtype=np.int64))
    lib = get_lib()
    if lib is None:
        order = np.lexsort((np.arange(len(groups)), -values, groups))
        sorted_groups = groups[order]
        starts = np.searchsorted(sorted_groups, np.arange(n_groups))
        ends = np.searchsorted(sorted_groups, np.arange(n_groups),
                               side="right")
        # within a group, equal values must prefer later event indices
        out, counts = [], np.zeros(n_groups, dtype=np.int64)
        for g in range(n_groups):
            seg = order[starts[g]:ends[g]]
            seg = sorted(seg, key=lambda e: (-values[e], -e))[:k]
            out.extend(seg)
            counts[g] = len(seg)
        return np.asarray(out, dtype=np.int64), counts
    out_idx = np.empty(min(len(groups), n_groups * k), dtype=np.int64)
    out_count = np.zeros(n_groups, dtype=np.int64)
    lib.group_top_k(_as_ptr(groups, ctypes.c_int32),
                    _as_ptr(values, ctypes.c_double), len(groups),
                    n_groups, k, _as_ptr(out_idx, ctypes.c_int64),
                    _as_ptr(out_count, ctypes.c_int64))
    total = int(out_count.sum())
    return out_idx[:total], out_count
