"""Native (C++) pieces of the host side, built with ``g++`` at first use
and loaded with ``ctypes``.

Counterpart of ``rich_text_to_image_tpu/native/``: ``bpe.cpp`` is the
tokenizer's byte-pair merge loop. It builds into the package's ``_build/``
(beside the CUDA libraries, git-ignored) under a name keyed by the source's
content, through a temporary file renamed into place, so that processes
building at once never load half a library. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "bpe.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB = None
_FAILED = None  # why the build or load failed, once it has


def lib_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libbpe_{h.hexdigest()[:16]}.so")


def load_bpe_lib():
    """Compile (once) and load the merge loop's library; None where it
    cannot be built or loaded (``load_error()`` says why), and the
    tokenizer then runs its Python loop."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None or _FAILED is not None:
            return _LIB
        so = lib_path()
        try:
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            _FAILED = f"{type(e).__name__}: {e}"
            return None
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = []
        lib.bpe_destroy.restype = None
        lib.bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.bpe_add_merge.restype = None
        lib.bpe_add_merge.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_char_p, ctypes.c_int]
        lib.bpe_encode_word.restype = ctypes.c_int
        lib.bpe_encode_word.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_int]
        _LIB = lib
        return _LIB


def load_error():
    """Why the library did not load, or None."""
    return _FAILED


class NativeBPE:
    """The C++ merge loop over ``merges`` (pairs in rank order):
    ``bpe(word) -> 'sym sym…'`` with ``</w>`` on the last symbol, as the
    tokenizer's Python ``_bpe``."""

    def __init__(self, merges):
        lib = load_bpe_lib()
        if lib is None:
            raise RuntimeError(f"native BPE library unavailable: {_FAILED}")
        self._lib = lib
        self._h = lib.bpe_create()
        for rank, (a, b) in enumerate(merges):
            lib.bpe_add_merge(self._h, a.encode("utf-8"), b.encode("utf-8"),
                              rank)
        self._buf = ctypes.create_string_buffer(1 << 16)

    def __call__(self, token: str) -> str:
        n = self._lib.bpe_encode_word(self._h, token.encode("utf-8"),
                                      self._buf, len(self._buf))
        if n < 0:
            raise ValueError("token too long for native BPE buffer")
        if n == 0:
            return token + "</w>"
        return self._buf.value.decode("utf-8")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.bpe_destroy(h)
