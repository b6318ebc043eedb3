"""Builds the package's CUDA sources into one shared library, at first use.

The kernels in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. Nothing
is built when the package is imported: the first wrapper that launches a
kernel calls :func:`library`, which compiles into ``_build/`` beside the
package (a name keyed by the sources' content, so an edited source builds
anew) and caches the handle for the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("attention.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
build_seconds = None  # wall time of this process's build, None if cached
ptxas_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librtt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if their library is not built yet; its path."""
    global build_seconds, ptxas_log
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(CSRC, n) for n in SOURCES]]
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    build_seconds = time.time() - t0
    ptxas_log = res.stderr
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        strides = [i64] * 12
        lib.rtt_attn_fwd.argtypes = (
            [ptr] * 4 + [i32] * 5 + strides + [f32, ptr])
        lib.rtt_attn_fwd.restype = i32
        lib.rtt_attn_avgp_fwd.argtypes = (
            [ptr] * 5 + [i32] * 5 + strides + [f32, ptr])
        lib.rtt_attn_avgp_fwd.restype = i32
        _LIB = lib
    return _LIB
