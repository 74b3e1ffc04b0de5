"""ctypes bridge to the native host components (native/*.cpp).

Port of ``orb_line_slam_tpu/utils/native.py``: builds
``native/build/libnative.so`` on demand with the repo's Makefile (``make
libnative`` in ``native/``: g++ and OpenCV's imgcodecs; no pybind11, a
plain C ABI and ctypes as the boundary) and binds the DBoW2 text
vocabulary parser (``get_native_lib`` 22-62, ``parse_orbvoc_native``
65-91) and the prefetching stereo-frame loader (``NativeStereoLoader``
94-129).  This is host code, not a device kernel.  Every caller has the
reference's own pure-Python path beside it, taken where the library
cannot be built.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libnative.so"
_lib = None


def get_native_lib():
    """Load (building if needed) the native library; None on failure."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "libnative"], cwd=_NATIVE_DIR, check=True,
                capture_output=True, timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.orbvoc_count.restype = ctypes.c_long
    lib.orbvoc_count.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.orbvoc_parse.restype = ctypes.c_long
    lib.orbvoc_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_get.restype = ctypes.c_int
    lib.loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def parse_orbvoc_native(path: str):
    """Fast ORBvoc.txt parse. Returns (k, L, parents, is_leaf, desc,
    weights) or None if the native lib is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    k = ctypes.c_int()
    L = ctypes.c_int()
    n = lib.orbvoc_count(str(path).encode(), ctypes.byref(k), ctypes.byref(L))
    if n <= 0:
        return None
    parents = np.zeros(n, np.int32)
    is_leaf = np.zeros(n, np.int32)
    desc = np.zeros((n, 32), np.uint8)
    weights = np.zeros(n, np.float64)
    got = lib.orbvoc_parse(
        str(path).encode(), n,
        parents.ctypes.data, is_leaf.ctypes.data,
        desc.ctypes.data, weights.ctypes.data,
    )
    if got <= 0:
        return None
    return (
        int(k.value), int(L.value),
        parents[:got], is_leaf[:got], desc[:got], weights[:got],
    )


class NativeStereoLoader:
    """Prefetching stereo-frame loader backed by the C++ thread pool."""

    def __init__(self, left_paths, right_paths, height, width,
                 n_workers: int = 3, ring: int = 8):
        lib = get_native_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.height, self.width = height, width
        self.n = len(left_paths)
        lp = (ctypes.c_char_p * self.n)(*[str(p).encode() for p in left_paths])
        rp = (ctypes.c_char_p * self.n)(*[str(p).encode() for p in right_paths])
        self._handle = lib.loader_create(lp, rp, self.n, height, width,
                                         n_workers, ring)

    def __len__(self):
        return self.n

    def get(self, idx: int):
        l = np.empty((self.height, self.width), np.uint8)
        r = np.empty((self.height, self.width), np.uint8)
        rc = self._lib.loader_get(self._handle, idx, l.ctypes.data, r.ctypes.data)
        if rc != 0:
            raise IndexError(f"frame {idx} unavailable")
        return l, r

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
