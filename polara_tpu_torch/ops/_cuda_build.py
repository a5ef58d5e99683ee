"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``polara_tpu_torch/csrc/*.cu`` for ``sm_90a``
(Hopper) into one shared library with a plain C interface, at first use,
under ``polara_tpu_torch/_build/``; the file name carries a hash of the
sources and flags, so an edited source builds anew.  The library is loaded
with ``ctypes``.  A missing compiler or a failed build raises with the
compiler's output: nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_library: Optional[ctypes.CDLL] = None
build_log = ""   # compiler output of the build this process ran, if any


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


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libpolara_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path."""
    global build_log
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sources()]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, target)   # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per
    process, with every entry point's argument types declared."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.polara_fused_score_topk
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        _library = lib
    return _library
