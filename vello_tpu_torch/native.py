"""ctypes bindings + build-on-demand for the C++ host runtime
(csrc/host/vello_native.cpp, built with g++ into build/) — the role of the
reference's compiled Rust host encoder. Falls back silently to the
pure-Python paths when unavailable (set VELLO_TPU_NO_NATIVE=1 to force the
fallback)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "host", "vello_native.cpp")
_LIB = os.path.join(_PKG, "build", "libvello_native.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("VELLO_TPU_NO_NATIVE"):
        _lib = False
        return _lib
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            # build under a private name, then rename: concurrent test
            # workers never load a half-written library
            os.makedirs(os.path.dirname(_LIB), exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.vn_encode_path.restype = ctypes.c_int
        lib.vn_encode_path.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int)]
        lib.vn_encode_polygons.restype = ctypes.c_int
        lib.vn_encode_polygons.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
        lib.vn_estimate.restype = ctypes.c_int
        lib.vn_estimate.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    except Exception:
        _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


def _cptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def encode_path(verbs: np.ndarray, points: np.ndarray,
                close_subpaths: bool
                ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """verbs (V,) u8, points (P, 2) f32 -> (tags u8, data (N,2) f32, n_segs),
    or None when native is unavailable."""
    lib = _load()
    if not lib:
        return None
    verbs = np.ascontiguousarray(verbs, dtype=np.uint8)
    points = np.ascontiguousarray(points, dtype=np.float32)
    nv = len(verbs)
    out_tags = np.empty(nv + 2, dtype=np.uint8)
    out_data = np.empty(2 * (len(points) + nv + 2), dtype=np.float32)
    counts = np.zeros(2, dtype=np.int32)
    n_segs = lib.vn_encode_path(
        _cptr(verbs, ctypes.c_uint8), nv,
        _cptr(points, ctypes.c_float), 1 if close_subpaths else 0,
        _cptr(out_tags, ctypes.c_uint8), _cptr(out_data, ctypes.c_float),
        _cptr(counts, ctypes.c_int))
    return (out_tags[:counts[0]], out_data[:counts[1]].reshape(-1, 2),
            int(n_segs))


def encode_polygons(polys, sizes
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """polys (sum, 2) f32 concatenated, sizes (K,) i32."""
    lib = _load()
    if not lib:
        return None
    polys = np.ascontiguousarray(polys, dtype=np.float32)
    sizes = np.ascontiguousarray(sizes, dtype=np.int32)
    total = len(polys)
    out_tags = np.empty(total + 2 * len(sizes) + 2, dtype=np.uint8)
    out_data = np.empty(2 * (total + len(out_tags)), dtype=np.float32)
    counts = np.zeros(2, dtype=np.int32)
    n_segs = lib.vn_encode_polygons(
        _cptr(polys, ctypes.c_float), _cptr(sizes, ctypes.c_int),
        len(sizes), _cptr(out_tags, ctypes.c_uint8),
        _cptr(out_data, ctypes.c_float), _cptr(counts, ctypes.c_int))
    return (out_tags[:counts[0]], out_data[:counts[1]].reshape(-1, 2),
            int(n_segs))


def estimate(points, kind, tmat, path_ix, n_paths, wt1, ht_tiles,
             tile_w, tile_h, tol, max_lines, hw=None, join=None):
    """C++ capacity estimator (BumpEstimator analog). Returns
    (est_lines, est_touches, est_path_tiles, est_live, rect (P,4) i32)
    or None when the native library is unavailable.

    hw/join: optional (S,) stroke half-widths + subpath-continuation
    flags — stroked segments estimate through the device stroke
    expansion (7 lines per centerline mini)."""
    lib = _load()
    if not lib:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    kd = np.ascontiguousarray(kind, dtype=np.int32)
    tm = np.ascontiguousarray(tmat, dtype=np.float32)
    pix = np.ascontiguousarray(path_ix, dtype=np.int32)
    hwp = None
    jnp_ = None
    if hw is not None:
        hwp = np.ascontiguousarray(hw, dtype=np.float32)
        jnp_ = np.ascontiguousarray(
            join if join is not None else np.zeros(len(kd), np.int32),
            dtype=np.int32)
    S = len(kd)
    P = max(int(n_paths), 1)
    ht1 = int(ht_tiles) + 1
    out = np.zeros(4, dtype=np.int64)
    rect = np.zeros((P, 4), dtype=np.int32)
    bbox = np.empty(P * 4, dtype=np.float64)
    hmin = np.empty((P + 1) * ht1, dtype=np.float32)
    hmax = np.empty((P + 1) * ht1, dtype=np.float32)
    lib.vn_estimate(
        _cptr(pts, ctypes.c_float), _cptr(kd, ctypes.c_int),
        _cptr(tm, ctypes.c_float), _cptr(pix, ctypes.c_int),
        _cptr(hwp, ctypes.c_float) if hwp is not None else None,
        _cptr(jnp_, ctypes.c_int) if jnp_ is not None else None,
        S, int(n_paths), int(wt1), int(ht_tiles),
        float(tile_w), float(tile_h), float(tol), int(max_lines),
        _cptr(out, ctypes.c_longlong), _cptr(rect, ctypes.c_int),
        _cptr(bbox, ctypes.c_double),
        _cptr(hmin, ctypes.c_float), _cptr(hmax, ctypes.c_float))
    return (int(out[0]), int(out[1]), int(out[2]), int(out[3]), rect)
