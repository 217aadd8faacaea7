"""Native (C++) host runtime: SPSC ring buffer + MPEG-TS framer.

The reference's runtime services (GNU Radio's circular buffers and the
sync-byte search of R8/R10) are C++; this module is their equivalent here —
compiled on first use with g++ into a shared object and bound with ctypes
(no pybind11 needed).  The object's file name carries a hash of the source
and the compiler flags, so a checkout only ever loads a library built from
its own committed source.  Pure-python fallbacks keep everything working
where a toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "ringbuffer.cc")
_BUILD_DIR = os.path.join(_DIR, "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None
_build_error: str | None = None


def lib_path() -> str:
    """Build product for the current source + flags (content-addressed)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libdvbt_native_{h.hexdigest()[:16]}.so")


def _build() -> str:
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "lib.so")
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    return path


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError, FileNotFoundError) as e:
        _build_error = str(e)
        return None
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_readable.restype = ctypes.c_uint64
    lib.ring_readable.argtypes = [ctypes.c_void_p]
    lib.ring_writable.restype = ctypes.c_uint64
    lib.ring_writable.argtypes = [ctypes.c_void_p]
    lib.ring_write.restype = ctypes.c_uint64
    lib.ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_uint64]
    lib.ring_peek.restype = ctypes.c_void_p
    lib.ring_peek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ring_consume.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ring_read.restype = ctypes.c_uint64
    lib.ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_uint64]
    lib.ts_find_sync.restype = ctypes.c_int64
    lib.ts_find_sync.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                 ctypes.c_int]
    lib.ts_sync_quality.restype = ctypes.c_int32
    lib.ts_sync_quality.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class RingBuffer:
    """SPSC byte ring with zero-copy contiguous reads (native when possible).

    Typed views: pass `dtype` to write/peek/read numpy arrays of any dtype;
    sizes are in ELEMENTS of that dtype.
    """

    def __init__(self, capacity: int, max_read: int, dtype=np.uint8):
        self.dtype = np.dtype(dtype)
        self._cap_b = capacity * self.dtype.itemsize
        self._maxread_b = max_read * self.dtype.itemsize
        lib = _load()
        if lib is not None:
            self._h = lib.ring_create(self._cap_b, self._maxread_b)
            self._lib = lib
            if not self._h:
                raise MemoryError("ring_create failed")
        else:  # pure-python fallback
            self._h = None
            self._buf = np.zeros((0,), np.uint8)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ring_destroy(h)
            self._h = None

    @property
    def readable(self) -> int:
        if self._h:
            return int(self._lib.ring_readable(self._h)) // self.dtype.itemsize
        return len(self._buf) // self.dtype.itemsize

    def write(self, arr: np.ndarray) -> int:
        a = np.ascontiguousarray(arr, self.dtype).view(np.uint8).reshape(-1)
        if self._h:
            n = self._lib.ring_write(self._h, a.ctypes.data, a.nbytes)
            assert n % self.dtype.itemsize == 0
            return int(n) // self.dtype.itemsize
        self._buf = np.concatenate([self._buf, a])
        return len(a) // self.dtype.itemsize

    def peek(self, n: int) -> np.ndarray | None:
        """Zero-copy view of the next n elements (valid until consume)."""
        nb = n * self.dtype.itemsize
        if self._h:
            p = self._lib.ring_peek(self._h, nb)
            if not p:
                return None
            raw = (ctypes.c_uint8 * nb).from_address(p)
            return np.frombuffer(raw, np.uint8).view(self.dtype)
        if len(self._buf) < nb:
            return None
        return self._buf[:nb].view(self.dtype)

    def consume(self, n: int) -> None:
        nb = n * self.dtype.itemsize
        if self._h:
            self._lib.ring_consume(self._h, nb)
        else:
            self._buf = self._buf[nb:]

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n * self.dtype.itemsize, np.uint8)
        if self._h:
            got = self._lib.ring_read(self._h, out.ctypes.data, out.nbytes)
            return out[:got].view(self.dtype)
        got = min(len(self._buf), out.nbytes)
        out[:got] = self._buf[:got]
        self._buf = self._buf[got:]
        return out[:got].view(self.dtype)


def ts_find_sync(buf: np.ndarray, confirm: int = 3) -> int:
    """First offset with `confirm` aligned 0x47/0xB8 syncs, or -1."""
    a = np.ascontiguousarray(buf, np.uint8).reshape(-1)
    lib = _load()
    if lib is not None:
        return int(lib.ts_find_sync(a.ctypes.data, len(a), confirm))
    for off in range(len(a) - 188 * confirm + 1):
        if all(a[off + k * 188] in (0x47, 0xB8) for k in range(confirm)):
            return off
    return -1


def ts_sync_quality(buf: np.ndarray) -> float:
    """Fraction of aligned sync bytes on the 188-byte grid."""
    a = np.ascontiguousarray(buf, np.uint8).reshape(-1)
    lib = _load()
    if lib is not None:
        return lib.ts_sync_quality(a.ctypes.data, len(a)) / 1000.0
    n = len(a) // 188
    if n == 0:
        return 0.0
    syncs = a[: n * 188: 188]
    return float(np.isin(syncs, (0x47, 0xB8)).mean())
