"""Builds the package's CUDA sources into shared libraries, at first use.

The kernels in ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``, one
shared library with a plain C interface per source, all compilers started
together, and loaded with ``ctypes``. Nothing is built when the package is
imported: the first wrapper that launches a kernel calls :func:`library`,
which compiles into ``_build/`` beside the package (names keyed by the
sources' content, so an edited source builds anew) and caches the handles
for the process.
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
SOURCES = ("attention.cu", "attention_stream.cu", "conv.cu")
HEADERS = ("common.cuh",)
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


def _lib_path(source: str) -> str:
    h = hashlib.sha256()
    for name in (source, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"librtt_{stem}_{h.hexdigest()[:16]}.so")


def build() -> dict[str, str]:
    """Compile every source whose library is not built yet, all at once;
    returns {source: path of its library}."""
    global build_seconds, ptxas_log
    paths = {src: _lib_path(src) for src in SOURCES}
    todo = [src for src in SOURCES if not os.path.exists(paths[src])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in todo:
        tmp = f"{paths[src]}.{os.getpid()}.tmp"
        procs.append((src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, tmp, proc in procs:  # wait for all, so none is left running
        _, err = proc.communicate()
        logs.append(f"== {src}\n{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, paths[src])  # atomic: never half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    build_seconds = time.time() - t0
    ptxas_log = "\n".join(logs)
    return paths


class _Kernels:
    """The C entry points of the built libraries, with their signatures."""

    def __init__(self, paths: dict[str, str]):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = [ctypes.c_longlong] * 12
        attn = ctypes.CDLL(paths["attention.cu"])
        stream = ctypes.CDLL(paths["attention_stream.cu"])
        conv = ctypes.CDLL(paths["conv.cu"])
        self._libs = (attn, stream, conv)  # keep the handles alive
        self.rtt_attn_fwd = attn.rtt_attn_fwd
        self.rtt_attn_fwd.argtypes = (
            [ptr] * 4 + [i32] * 5 + strides + [f32, ptr])
        self.rtt_attn_avgp_fwd = attn.rtt_attn_avgp_fwd
        self.rtt_attn_avgp_fwd.argtypes = (
            [ptr] * 5 + [i32] * 5 + strides + [f32, ptr])
        self.rtt_attn_stream_fwd = stream.rtt_attn_stream_fwd
        self.rtt_attn_stream_fwd.argtypes = (
            [ptr] * 4 + [i32] * 5 + strides + [f32, i32, ptr])
        self.rtt_conv3x3_fwd = conv.rtt_conv3x3_fwd
        self.rtt_conv3x3_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
        for fn in (self.rtt_attn_fwd, self.rtt_attn_avgp_fwd,
                   self.rtt_attn_stream_fwd, self.rtt_conv3x3_fwd):
            fn.restype = i32


def library() -> _Kernels:
    """The loaded kernel entry points (built on first call)."""
    global _LIB
    if _LIB is None:
        _LIB = _Kernels(build())
    return _LIB
