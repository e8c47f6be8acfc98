"""ctypes bindings for the native prefetching TUM loader (`cpp/tum_loader.cpp`),
a copy of the JAX package's `io/native_loader.py`.

Builds the shared library on first use with g++, libpng and zlib (the
C ABI and ctypes are the binding layer) into `build/torch_native/`, apart
from the JAX package's `build/libtum_loader.so`, so that the two packages
never build one file at once. A failed build raises; callers that have no
toolchain use the pure-Python `io.tum.TumSequence`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _build_library() -> str:
    root = _repo_root()
    src = os.path.join(root, "cpp", "tum_loader.cpp")
    out_dir = os.path.join(root, "build", "torch_native")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libtum_loader.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    # Build under a private name and move it into place in one step, so a
    # concurrent loader never opens a half-written file.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", src,
        "-o", tmp, "-lpng", "-lz", "-pthread",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)
    return so


def get_library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            so = _build_library()
            lib = ctypes.CDLL(so)
            lib.tum_loader_open.restype = ctypes.c_void_p
            lib.tum_loader_open.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ]
            lib.tum_loader_size.restype = ctypes.c_long
            lib.tum_loader_size.argtypes = [ctypes.c_void_p]
            lib.tum_loader_next.restype = ctypes.c_int
            lib.tum_loader_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.tum_loader_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


class NativeTumSequence:
    """Streaming iterator over a TUM sequence with native prefetch.

    Unlike TumSequence (random access, synchronous PIL decode), frames
    arrive strictly in order, decoded ahead by a worker pool: the
    consumer's cost is a memcpy. Depth is returned as uint16 millimetres
    by default (what `SlamSystem.track_rgbd` takes as uint16) or as
    float32 metres with as_float=True.
    """

    def __init__(self, root: str, association: str | None = None,
                 depth_factor: float = 5000.0, workers: int = 2,
                 prefetch: int = 16, width: int = 640, height: int = 480,
                 as_float: bool = False):
        association = association or os.path.join(root, "associate.txt")
        lib = get_library()
        self._lib = lib
        self._h = lib.tum_loader_open(
            root.encode(), association.encode(), workers, prefetch
        )
        if not self._h:
            raise FileNotFoundError(f"cannot open {association}")
        self._n = int(lib.tum_loader_size(self._h))
        self._w, self._hgt = width, height
        self.depth_factor = depth_factor
        self.as_float = as_float
        self._i = 0

    def __len__(self):
        return self._n

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        rgb = np.empty((self._hgt, self._w, 3), np.uint8)
        depth = np.empty((self._hgt, self._w), np.uint16)
        stamp = ctypes.c_double()
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.tum_loader_next(
            self._h,
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ctypes.byref(stamp), ctypes.byref(w), ctypes.byref(h),
        )
        self._i += 1
        if rc != 1:
            raise IOError(f"frame {self._i - 1} failed to decode (rc={rc})")
        if (w.value, h.value) != (self._w, self._hgt):
            raise IOError(
                f"frame size {w.value}x{h.value} != expected {self._w}x{self._hgt}"
            )
        if self.as_float:
            d = depth.astype(np.float32) / self.depth_factor
        else:
            # Sensor units (0.2 mm at the standard TUM factor 5000)
            # rescaled to millimetres.
            d = (depth.astype(np.float32) / self.depth_factor * 1000.0).astype(np.uint16)
        return float(stamp.value), rgb, d

    def close(self):
        if self._h:
            self._lib.tum_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
