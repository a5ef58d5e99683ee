"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``polara_tpu_torch/csrc/*.cu`` for ``sm_90a``
(Hopper) into one shared library with a plain C interface, at first use,
under ``polara_tpu_torch/_build/``; the file name carries a hash of the
sources and flags, so an edited source builds anew.  The library is loaded
with ``ctypes``.  A missing compiler or a failed build raises with the
compiler's output: nothing falls back to a plain version.  ``defines``
build a variant of the same sources (``-D`` macros), for measurements
that switch a phase of a kernel off; the port itself loads the library
built without them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libraries: Dict[Tuple[str, ...], ctypes.CDLL] = {}
build_log = ""   # compiler output (ptxas -v) of the loaded library's build


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _flags(defines: Tuple[str, ...]) -> List[str]:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(defines: Tuple[str, ...] = ()) -> Path:
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpolara_torch_kernels_{digest.hexdigest()[:16]}.so"


def build(defines: Tuple[str, ...] = ()) -> Path:
    """Compile the kernels unless a library for these sources and
    ``defines`` exists; returns its path (the compiler's output is beside
    it, with the suffix ``.log``)."""
    target = library_path(defines)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *_flags(defines), "-o", tmp,
           *[str(s) for s in sources()]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)   # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """``{mangled kernel name: {"registers", "spill_stores",
    "spill_loads"}}`` from ``ptxas -v`` output (spills in bytes)."""
    report: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([\w$.]+)", line)
        if found:
            name = found.group(1)
            report.setdefault(name, {})
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if spills and name:
            report[name].update(spill_stores=int(spills.group(1)),
                                spill_loads=int(spills.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            report[name]["registers"] = int(regs.group(1))
    return report


def load_library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library (or its ``defines`` variant), built on first use
    and loaded once per process, with every entry point's argument types
    declared."""
    global build_log
    if defines not in _libraries:
        path = build(defines)
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.polara_fused_score_topk
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        fn = lib.polara_fused_blocks_per_sm
        fn.argtypes = [i32, i32, ctypes.POINTER(i32)]
        fn.restype = i32
        _libraries[defines] = lib
        if not defines:
            build_log = path.with_suffix(".log").read_text()
    return _libraries[defines]
