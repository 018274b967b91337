"""ctypes bindings for the native (C++) token-shard reader.

The port's copy of ``orion_tpu/data/native`` (``native_loader.cpp``, a
plain C ABI): the same gather, byte for byte the numpy reader's. It is
built with ``g++`` at first use into ``orion_tpu_torch/_build/`` (listed
in ``.gitignore``; never the package directory), under a name that holds
the source's hash, so an edited source rebuilds. Concurrent first uses
race safely: each builds to its own temporary file and renames it into
place. A failed build raises ImportError; ``data/loader.py`` then reads
with numpy, logs why, and says which reader it uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
_BUILD_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libnative_loader-{digest}.so"


def _build() -> Path:
    target = library_path()
    with _BUILD_LOCK:
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.tmp.{os.getpid()}")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
               str(SOURCE), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", None) or str(e)
            raise ImportError(f"native reader build failed: {detail}") from e
        os.replace(tmp, target)
        return target


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build()))
    lib.otn_open.argtypes = [ctypes.c_char_p]
    lib.otn_open.restype = ctypes.c_void_p
    lib.otn_len_bytes.argtypes = [ctypes.c_void_p]
    lib.otn_len_bytes.restype = ctypes.c_longlong
    lib.otn_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.otn_gather.restype = ctypes.c_int
    lib.otn_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.otn_prefetch.restype = None
    lib.otn_close.argtypes = [ctypes.c_void_p]
    lib.otn_close.restype = None
    return lib


_lib: ctypes.CDLL | None = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


class NativeReader:
    """Reader over a flat token file: len() in elements, gather(),
    prefetch(). Drop-in for the numpy reader of ``data/loader.py``, with a
    multithreaded native gather and MADV_WILLNEED readahead."""

    def __init__(self, path: str, dtype: np.dtype, num_threads: int = 0):
        self._lib = _get_lib()
        self._h = self._lib.otn_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"native reader could not open {path!r}")
        self.dtype = np.dtype(dtype)
        self.path = path
        self._nthreads = num_threads or min(8, os.cpu_count() or 1)

    def __len__(self) -> int:
        return self._lib.otn_len_bytes(self._h) // self.dtype.itemsize

    def _offsets_arg(self, offsets: np.ndarray):
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        return offs, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))

    def gather(self, offsets: np.ndarray, width: int) -> np.ndarray:
        offs, ptr = self._offsets_arg(offsets)
        out = np.empty((len(offs), width), self.dtype)
        rc = self._lib.otn_gather(
            self._h, ptr, len(offs), width, self.dtype.itemsize,
            out.ctypes.data_as(ctypes.c_void_p), self._nthreads,
        )
        if rc != 0:
            raise IndexError(f"gather window out of bounds (file has {len(self)} tokens)")
        return out

    def prefetch(self, offsets: np.ndarray, width: int) -> None:
        offs, ptr = self._offsets_arg(offsets)
        self._lib.otn_prefetch(self._h, ptr, len(offs), width, self.dtype.itemsize)

    def close(self) -> None:
        if self._h:
            self._lib.otn_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
