"""The latent cache's read-ahead ring (hyvideo_prfl_tpu/data/native_loader.py).

``csrc/latent_loader.cpp``: an mmap ``.npy`` parser and a worker-thread
ring that hands files back in submission order, bound through ctypes.
``NativeStream.read_many`` submits a sample's files at once, so they are
read in parallel; ``NativePrefetcher`` iterates a fixed list of files.

The library is built from the port's own copy of the source with the host
C++ compiler (``$CXX``, else ``c++``/``g++``) at first use, into
``build/hyvideo_prfl_torch/`` under the repository root, named by a digest
of the source and flags; the build writes a temporary file and renames it,
so processes that build at once never load a half-written library. Unlike
the JAX module, nothing falls back to numpy: a failed build or load raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "latent_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hyvideo_prfl_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", "-Wall"]

# the ring's dtype codes
_DTYPES = {0: np.float32, 1: np.float16, 2: np.int64, 3: np.uint8, 4: np.float64}

_lib = None
_lib_lock = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler found to build the latent-cache ring "
                       "(set CXX, or put c++ or g++ on PATH)")


def build() -> Path:
    """The ring's shared library, compiled unless it exists."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"liblatentloader_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.{threading.get_ident()}.so")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded ring library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.ll_open.restype = ctypes.c_void_p
            handle.ll_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
            handle.ll_open_stream.restype = ctypes.c_void_p
            handle.ll_open_stream.argtypes = [ctypes.c_int, ctypes.c_int]
            handle.ll_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            handle.ll_next.restype = ctypes.c_int
            handle.ll_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.POINTER(ctypes.c_longlong),
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)]
            handle.ll_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
            handle.ll_error.restype = ctypes.c_char_p
            handle.ll_error.argtypes = [ctypes.c_void_p]
            handle.ll_close.argtypes = [ctypes.c_void_p]
            _lib = handle
    return _lib


class _Slots:
    """ll_next's out-arguments, and one call of it -> a copied array, None
    at the end of a bounded stream; IOError for a file that failed."""

    def __init__(self, handle, h):
        self.handle, self.h = handle, h
        self.data = ctypes.c_void_p()
        self.shape = (ctypes.c_longlong * 8)()
        self.ndim = ctypes.c_int()
        self.dtype = ctypes.c_int()

    def next(self):
        handle = self.handle
        slot = handle.ll_next(self.h, ctypes.byref(self.data), self.shape,
                              ctypes.byref(self.ndim), ctypes.byref(self.dtype))
        if slot == -1:
            return None
        if slot == -2:
            raise IOError(handle.ll_error(self.h).decode())
        shape = tuple(self.shape[i] for i in range(self.ndim.value))
        dtype = np.dtype(_DTYPES[self.dtype.value])
        n = int(np.prod(shape)) * dtype.itemsize
        buf = ctypes.cast(self.data, ctypes.POINTER(ctypes.c_char * n)).contents
        out = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
        handle.ll_release(self.h, slot)
        return out


class NativeStream:
    """Submit-and-collect over the ring: ``read_many(paths)`` submits every
    path, then collects the arrays in submission order. One reader at a
    time (a lock)."""

    def __init__(self, slots: int = 16, threads: int = 4):
        self._lib = lib()
        self._h = self._lib.ll_open_stream(slots, threads)
        self._lock = threading.Lock()

    def read_many(self, paths: Sequence[str]) -> List[np.ndarray]:
        with self._lock:
            if self._h is None:
                raise ValueError("read_many on a closed NativeStream")
            for p in paths:
                self._lib.ll_submit(self._h, os.fsencode(p))
            slots = _Slots(self._lib, self._h)
            out, err = [], None
            # collect every submitted file even after an error, so the next
            # call's files are matched to its own submissions
            for _ in paths:
                try:
                    out.append(slots.next())
                except IOError as e:
                    err = err or e
        if err is not None:
            raise err
        return out

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.ll_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativePrefetcher:
    """The arrays of a fixed list of ``.npy`` files, in order, read ahead by
    the ring's workers."""

    def __init__(self, paths: Sequence[str], slots: int = 8, threads: int = 4):
        self.paths = list(paths)
        self._lib = lib()
        arr = (ctypes.c_char_p * len(self.paths))(*map(os.fsencode, self.paths))
        self._h = self._lib.ll_open(arr, len(self.paths), slots, threads)

    def __iter__(self):
        slots = _Slots(self._lib, self._h)
        while True:
            out = slots.next()
            if out is None:
                return
            yield out

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.ll_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
