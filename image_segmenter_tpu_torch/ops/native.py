"""ctypes bindings for the host C++ geometry engine (ops/csrc/geometry.cpp).

Counterpart of image_segmenter_tpu/ops/native.py. The port ships its own
copy of the repository's native/geometry.cpp, byte for byte, as package
data (`ops/csrc/geometry.cpp`), so an installed port builds without the
repository around it. It is built with g++ at first use into the port's
own directory (`ops/_native_build/`, not the JAX package's
`native/build/`). The library
is written under a temporary name and moved into place with os.replace, so
processes that build at the same time never load a half-written file.

A failed build raises: no caller falls back to the numpy twins of
ops/contours.py, which the tests hold these entries to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import List

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "ops", "csrc", "geometry.cpp")
_BUILD_DIR = os.path.join(_PKG, "ops", "_native_build")
_SO = os.path.join(_BUILD_DIR, "libgeometry.so")

_lock = threading.Lock()
_lib = None


def _build() -> str:
    if not os.path.isfile(_SRC):
        raise RuntimeError(f"native geometry source not found: {_SRC}")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.isfile(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{proc.stderr}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


def get_lib():
    """The loaded library; builds it on first use and raises if it cannot."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.ig_trace_contours.restype = ctypes.c_int
        lib.ig_trace_contours.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.ig_approx_polydp.restype = ctypes.c_int64
        lib.ig_approx_polydp.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p]
        lib.ig_fill_polygon.restype = None
        lib.ig_fill_polygon.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64]
        lib.ig_label_components.restype = None
        lib.ig_label_components.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def trace_contours(mask: np.ndarray) -> List[np.ndarray]:
    """External contours of a 2D mask (nonzero = set), one (N, 2) int32
    array of (x, y) per 8-connected component."""
    lib = get_lib()
    m = np.ascontiguousarray(mask.astype(np.uint8))
    if m.ndim != 2:
        raise ValueError("mask must be 2D")
    h, w = m.shape
    max_pts = int(16 * h * w + 64)  # tracing can revisit pixels on thin chains
    max_contours = int(h * w // 2 + 16)
    pts = np.empty((max_pts, 2), np.int32)
    offsets = np.empty(max_contours + 1, np.int64)
    n = lib.ig_trace_contours(m.ctypes.data, h, w, pts.ctypes.data,
                              max_pts, offsets.ctypes.data, max_contours)
    if n < 0:
        raise RuntimeError("ig_trace_contours ran out of its output buffers")
    return [pts[offsets[i]:offsets[i + 1]].copy() for i in range(n)]


def approx_poly_dp(pts: np.ndarray, epsilon: float) -> np.ndarray:
    """Douglas-Peucker on a closed polygon of (N, 2) integer points."""
    lib = get_lib()
    p = np.ascontiguousarray(np.asarray(pts).astype(np.int32).reshape(-1, 2))
    out = np.empty_like(p)
    m = lib.ig_approx_polydp(p.ctypes.data, len(p), float(epsilon),
                             out.ctypes.data)
    return out[:m].copy()


def label_components_host(color_id: np.ndarray, valid: np.ndarray,
                          connectivity: int = 8):
    """Host union-find labelling with the contract of
    ops/connected_components.component_stats (labels = raster-first linear
    index per component, -1 invalid; per-root sizes and bboxes). Returns
    (labels, sizes, bbox) as numpy int32."""
    lib = get_lib()
    cid = np.ascontiguousarray(color_id.astype(np.int32, copy=False))
    v = np.ascontiguousarray(valid.astype(np.uint8, copy=False))
    if cid.ndim != 2 or v.shape != cid.shape:
        raise ValueError("color_id and valid must be 2D of one shape")
    h, w = cid.shape
    labels = np.empty((h, w), np.int32)
    sizes = np.empty(h * w, np.int32)
    bbox = np.empty((h * w, 4), np.int32)
    lib.ig_label_components(cid.ctypes.data, v.ctypes.data, h, w,
                            int(connectivity), labels.ctypes.data,
                            sizes.ctypes.data, bbox.ctypes.data)
    return labels, sizes, bbox


def fill_polygon(mask_out: np.ndarray, pts: np.ndarray) -> None:
    """Even-odd scanline fill of a closed polygon, boundary pixels
    included, into a C-contiguous uint8 (H, W) mask (set to 1)."""
    if mask_out.dtype != np.uint8 or not mask_out.flags.c_contiguous \
            or mask_out.ndim != 2:
        raise ValueError("mask_out must be a C-contiguous 2D uint8 array")
    lib = get_lib()
    p = np.ascontiguousarray(np.asarray(pts).astype(np.int32).reshape(-1, 2))
    lib.ig_fill_polygon(mask_out.ctypes.data, mask_out.shape[0],
                        mask_out.shape[1], p.ctypes.data, len(p))
