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
SOURCES = ("attention.cu", "conv.cu", "qk_norm_rope.cu")
HEADERS = ("common.cuh", "wgmma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}  # extra flags -> loaded entry points
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


def _lib_path(source: str, extra: tuple = ()) -> str:
    h = hashlib.sha256()
    for name in (source, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"librtt_{stem}_{h.hexdigest()[:16]}.so")


def build(extra: tuple = ()) -> dict[str, str]:
    """Compile every source whose library is not built yet, all at once,
    with the flags ``extra`` added to ``NVCC_FLAGS``; returns {source: path
    of its library}."""
    global build_seconds, ptxas_log
    paths = {src: _lib_path(src, extra) for src in SOURCES}
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
            [nvcc, *NVCC_FLAGS, *extra, "-o", tmp, os.path.join(CSRC, src)],
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
        strides = [ctypes.c_longlong] * 3
        attn = ctypes.CDLL(paths["attention.cu"])
        conv = ctypes.CDLL(paths["conv.cu"])
        qk = ctypes.CDLL(paths["qk_norm_rope.cu"])
        self._libs = (attn, conv, qk)  # keep the handles alive
        self.rtt_attn_fwd = attn.rtt_attn_fwd
        self.rtt_attn_fwd.argtypes = (
            [ptr] * 5 + [i32] * 5 + strides * 4 + [f32, i32, i32, ptr])
        self.rtt_attn_pavg = attn.rtt_attn_pavg
        self.rtt_attn_pavg.argtypes = (
            [ptr] * 4 + [i32] * 5 + strides * 2 + [f32, i32, ptr])
        self.rtt_conv3x3_fwd = conv.rtt_conv3x3_fwd
        self.rtt_conv3x3_fwd.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        self.rtt_qk_norm_rope = qk.rtt_qk_norm_rope
        self.rtt_qk_norm_rope.argtypes = (
            [ptr] * 8 + [i32] * 4 + [ptr] * 2 + [f32] + [ptr] * 3)
        for fn in (self.rtt_attn_fwd, self.rtt_attn_pavg,
                   self.rtt_conv3x3_fwd, self.rtt_qk_norm_rope):
            fn.restype = i32


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where a kernel would be asked for a result that autograd must
    differentiate: grad mode on and an input requiring a gradient. The
    kernels have no backward pass, so their output would be cut off from
    the graph and its gradient silently zero. Every wrapper calls this on
    a CUDA tensor before it launches; CPU tensors take the plain versions,
    which autograd differentiates."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward pass, and an input "
            "requires a gradient; run it under torch.no_grad(), or "
            "differentiate on the CPU (the plain versions). A backward on "
            "the card waits for the training slice (ROADMAP.md, Queue 1)")


def library(extra: tuple = ()) -> _Kernels:
    """The loaded kernel entry points (built on first call). ``extra``:
    nvcc flags of a second build beside the package's own, such as the
    ``-DRTT_ALL_TILES`` of ``scripts/port_tile_sweep.py``."""
    extra = tuple(extra)
    if extra not in _LIBS:
        _LIBS[extra] = _Kernels(build(extra))
    return _LIBS[extra]
