"""ctypes binding of the shared native helpers in ``native/``.

``native/libpathtracer_native.so`` (built by ``make -C native``) exports
``pt_build_bvh``, an SAH BVH builder that emits the same flat node arrays as
the numpy builder in ``bvh.py``, and ``pt_write_png``.  Both packages load the
same library.  When it is absent or fails to load, ``get_lib`` returns None
and every caller runs its numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _find_lib() -> Optional[str]:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "native", "libpathtracer_native.so")
    return path if os.path.exists(path) else None


def get_lib():
    """The loaded library, or None when it is absent or does not load."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.pt_write_png.restype = ctypes.c_int
    lib.pt_write_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int,
    ]
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int)
    lib.pt_build_bvh.restype = ctypes.c_int
    # n, tri_lb, tri_rt, centroids (n, 3); out lb, rt (2n, 3); out left,
    # right, tri_start, tri_end (2n,); out tri_idx (n,)
    lib.pt_build_bvh.argtypes = [ctypes.c_int, fptr, fptr, fptr, fptr, fptr,
                                 iptr, iptr, iptr, iptr, iptr]
    _LIB = lib
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def write_png(filename: str, rgb_u8: np.ndarray) -> bool:
    """Native PNG write; False when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w, _ = rgb_u8.shape
    return bool(lib.pt_write_png(
        filename.encode(),
        rgb_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h))


def build_bvh(tri_lb, tri_rt, centroids) -> Optional[Tuple[np.ndarray, ...]]:
    """Native SAH build: (lb, rt, left, right, start, end, tri_idx), or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = tri_lb.shape[0]
    tri_lb = np.ascontiguousarray(tri_lb, np.float32)
    tri_rt = np.ascontiguousarray(tri_rt, np.float32)
    centroids = np.ascontiguousarray(centroids, np.float32)
    cap = 2 * n
    lb = np.zeros((cap, 3), np.float32)
    rt = np.zeros((cap, 3), np.float32)
    left, right, start, end = (np.zeros(cap, np.int32) for _ in range(4))
    tri_idx = np.zeros(n, np.int32)
    m = lib.pt_build_bvh(n, _fptr(tri_lb), _fptr(tri_rt), _fptr(centroids),
                         _fptr(lb), _fptr(rt), _iptr(left), _iptr(right),
                         _iptr(start), _iptr(end), _iptr(tri_idx))
    if m <= 0:
        return None
    return lb[:m], rt[:m], left[:m], right[:m], start[:m], end[:m], tri_idx
