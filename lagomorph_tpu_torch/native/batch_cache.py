"""ctypes binding of the minibatch cache with background read-ahead
(``batch_cache.cpp``) and its ``g++`` build.

The library is compiled at first use into ``lagomorph_tpu_torch/_build/``
under a name that carries a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is reused (as the CUDA kernels'
``ops/kernels/_build.py`` names its library).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..data import _cache_tmpdir
from ..utils import progress

__all__ = ["NativeBatchCache", "build_library", "native_available"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "batch_cache.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None


def native_available() -> bool:
    """True when ``g++`` is on the path (the cache can be built)."""
    return shutil.which("g++") is not None


def build_library() -> str:
    """The path of the compiled library, built now if it is missing;
    raises when ``g++`` is missing or fails."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libbatch_cache_{digest}.so")
    if os.path.exists(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native batch cache cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}) on {SOURCE}:\n{r.stderr[-3000:]}")
    os.replace(tmp, so)
    return so


def _library():
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.bc_create.restype = ctypes.c_void_p
            lib.bc_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.bc_write.restype = ctypes.c_int
            lib.bc_write.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_int64]
            lib.bc_prefetch.restype = None
            lib.bc_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.bc_get.restype = ctypes.c_int
            lib.bc_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64]
            lib.bc_destroy.restype = None
            lib.bc_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


class NativeBatchCache:
    """Minibatches cached as raw binary files in a temporary directory
    (under ``cache_dir``) and replayed with background read-ahead: reading
    batch ``i`` starts the read of ``i + 1`` on the library's thread, which
    overlaps the caller's compute.  Random-access and iterable, as
    :class:`..data.CachedDataLoader`.

    A process forked from the one that made the cache (a
    :class:`..data.ProcessPrefetcher` worker) has no read-ahead thread and
    may hold a copy of its lock as the fork found it, so it reads the batch
    files itself with numpy and never enters the library."""

    def __init__(self, batches, cache_dir=None, progress_bar=False):
        self._lib = _library()
        self._pid = os.getpid()
        batches = list(batches)
        self._meta = []  # (shape, dtype) of each batch
        self._tmpdir = _cache_tmpdir(cache_dir, "NativeBatchCache")
        self._h = self._lib.bc_create(self._tmpdir.name.encode(), len(batches))
        if progress_bar:
            batches = progress(batches, desc="Caching minibatches")
        for i, b in enumerate(batches):
            b = np.ascontiguousarray(b)
            self._meta.append((b.shape, b.dtype))
            if self._lib.bc_write(self._h, i, b.ctypes.data, b.nbytes) != 0:
                raise IOError(f"failed to write batch {i}")

    def __len__(self):
        return len(self._meta)

    def __getitem__(self, i):
        shape, dtype = self._meta[i]
        if os.getpid() != self._pid:
            path = os.path.join(self._tmpdir.name, f"batch_{i}.bin")
            return np.fromfile(path, dtype=dtype).reshape(shape)
        out = np.empty(shape, dtype=dtype)
        r = self._lib.bc_get(self._h, i, out.ctypes.data, out.nbytes)
        if r != 0:
            raise IOError(f"failed to read batch {i} (code {r})")
        if i + 1 < len(self._meta):
            self._lib.bc_prefetch(self._h, i + 1)
        return out

    def __iter__(self):
        if self._meta:
            self._lib.bc_prefetch(self._h, 0)
        for i in range(len(self._meta)):
            yield self[i]

    def close(self):
        """Stop the read-ahead thread and delete the files (in the process
        that made the cache; idempotent)."""
        if getattr(self, "_h", None) and os.getpid() == self._pid:
            self._lib.bc_destroy(self._h)
            self._h = None
            self._tmpdir.cleanup()

    def __del__(self):  # pragma: no cover - best-effort clean-up
        try:
            self.close()
        except Exception:
            pass
