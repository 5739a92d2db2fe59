"""Contour tracing, polygon simplification, and rasterization (host side).

Counterpart of image_segmenter_tpu/ops/contours.py, numpy only: the
reference's cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE),
cv2.approxPolyDP, cv2.fillPoly and cv2.arcLength, used by the contour
smoother. These are sequential pointer-chasing geometry over component
masks, so they run on the host.

The public functions run in the native engine (ops/native.py). The JAX
module's pure-Python bodies stay here as the `*_plain` twins, which the
tests hold the native entries to; no public function falls back to them.
"""

from __future__ import annotations

from typing import List

import numpy as np

from image_segmenter_tpu_torch.ops import native as NAT

# Moore neighborhood in clockwise order starting from W (dx, dy),
# matching cv2's border following direction conventions closely enough
# for external contours.
_MOORE = [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)]


def external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """External contours of a binary mask, one (N, 2) array of (x, y) pixel
    coordinates per 8-connected component (boundary pixels, clockwise-ish).

    Equivalent in role to cv2.findContours(..., RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE) — vertices are boundary pixels with collinear runs
    compressed. Runs in the native engine.
    """
    return NAT.trace_contours(mask)


def external_contours_plain(mask: np.ndarray) -> List[np.ndarray]:
    """numpy twin of external_contours (the JAX module's Python body)."""
    m = mask.astype(bool)
    h, w = m.shape
    padded = np.zeros((h + 2, w + 2), bool)
    padded[1:-1, 1:-1] = m
    visited = np.zeros_like(padded)
    contours = []

    # Start pixels: first pixel of each component in raster order whose left
    # neighbor is background (outer border start).
    ys, xs = np.nonzero(padded & ~np.roll(padded, 1, axis=1))
    for y0, x0 in zip(ys, xs):
        if visited[y0, x0]:
            continue
        # Moore-neighbor tracing. Termination: the walk is deterministic, so
        # once we stand on the start pixel and the computed NEXT pixel equals
        # the walk's second pixel, the orbit repeats — stop. (Plain Jacob's
        # criterion can fail to trigger on rho-shaped walks whose cycle
        # excludes the initial state.)
        contour = []
        b = (x0, y0)
        prev = (x0 - 1, y0)  # background pixel to the left
        start = b
        second = None
        while True:
            # candidate move from (b, prev)
            dx, dy = prev[0] - b[0], prev[1] - b[1]
            try:
                i0 = _MOORE.index((dx, dy))
            except ValueError:
                i0 = 0
            found = False
            for k in range(1, 9):
                d = _MOORE[(i0 + k) % 8]
                nx, ny = b[0] + d[0], b[1] + d[1]
                if padded[ny, nx]:
                    nprev = (b[0] + _MOORE[(i0 + k - 1) % 8][0],
                             b[1] + _MOORE[(i0 + k - 1) % 8][1])
                    found = True
                    break
            if second is not None and b == start and found and (nx, ny) == second:
                break  # orbit repeats; start already recorded
            contour.append((b[0] - 1, b[1] - 1))  # unpad
            visited[b[1], b[0]] = True
            if not found:  # isolated pixel
                break
            if second is None:
                second = (nx, ny)
            prev = nprev
            b = (nx, ny)
            if len(contour) > 4 * (h + 2) * (w + 2):  # safety
                break
        pts = np.array(contour, dtype=np.int32)
        contours.append(_compress_collinear(pts))
    return contours


def _compress_collinear(pts: np.ndarray) -> np.ndarray:
    """CHAIN_APPROX_SIMPLE-style compression: drop points collinear with
    their neighbors along the 8-connected chain."""
    if len(pts) < 3:
        return pts
    # Tracing emits unit 8-steps; a vertex is redundant iff its incoming and
    # outgoing steps are identical.
    d1 = pts - np.roll(pts, 1, axis=0)
    d2 = np.roll(pts, -1, axis=0) - pts
    keep = ~np.all(d1 == d2, axis=1)
    if not keep.any():
        return pts[:1]
    return pts[keep]


def arc_length(pts: np.ndarray, closed: bool = True) -> float:
    """Polygon perimeter (cv2.arcLength)."""
    if len(pts) < 2:
        return 0.0
    p = pts.astype(np.float64)
    seg = np.roll(p, -1, axis=0) - p if closed else p[1:] - p[:-1]
    return float(np.sqrt((seg ** 2).sum(axis=1)).sum())


def approx_poly_dp(pts: np.ndarray, epsilon: float, closed: bool = True) -> np.ndarray:
    """Douglas-Peucker polygon simplification (cv2.approxPolyDP). A closed
    polygon runs in the native engine; the engine has no open form, so an
    open curve runs in numpy."""
    n = len(pts)
    if n < 3 or epsilon <= 0:
        return pts.copy()
    if closed:
        return NAT.approx_poly_dp(pts, epsilon)
    return approx_poly_dp_plain(pts, epsilon, closed=False)


def approx_poly_dp_plain(pts: np.ndarray, epsilon: float,
                         closed: bool = True) -> np.ndarray:
    """numpy twin of approx_poly_dp (the JAX module's Python body)."""
    n = len(pts)
    if n < 3 or epsilon <= 0:
        return pts.copy()
    p = pts.astype(np.float64)
    if closed:
        # split at the two farthest-apart points, run DP on both halves
        d = np.linalg.norm(p - p[0], axis=1)
        far = int(np.argmax(d))
        idx1 = _dp(p, 0, far, epsilon)
        idx2 = _dp(p, far, n - 1, epsilon) if far < n - 1 else []
        keep = sorted(set([0, far, n - 1] + idx1 + idx2))
    else:
        keep = sorted(set([0, n - 1] + _dp(p, 0, n - 1, epsilon)))
    return pts[np.array(keep, dtype=np.int64)]


def _dp(p: np.ndarray, i: int, j: int, eps: float) -> List[int]:
    """Indices to keep strictly between i and j (iterative DP)."""
    out: List[int] = []
    stack = [(i, j)]
    while stack:
        a, b = stack.pop()
        if b <= a + 1:
            continue
        seg = p[b] - p[a]
        L = np.linalg.norm(seg)
        mid = p[a + 1 : b]
        if L == 0:
            dist = np.linalg.norm(mid - p[a], axis=1)
        else:
            rel = mid - p[a]
            dist = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / L
        kmax = int(np.argmax(dist))
        if dist[kmax] > eps:
            k = a + 1 + kmax
            out.append(k)
            stack.append((a, k))
            stack.append((k, b))
    return out


def fill_polygon(mask_out: np.ndarray, pts: np.ndarray) -> None:
    """Rasterize a closed polygon into mask_out (in place, value True).

    cv2.fillPoly-style: even-odd scanline fill including boundary pixels.
    Runs in the native engine, which fills a C-contiguous uint8 mask; any
    other mask gets the engine's fill through a uint8 scratch plane.
    """
    if mask_out.dtype == np.uint8 and mask_out.flags.c_contiguous:
        NAT.fill_polygon(mask_out, pts)
        return
    scratch = np.zeros(mask_out.shape, np.uint8)
    NAT.fill_polygon(scratch, pts)
    mask_out[scratch > 0] = True


def fill_polygon_plain(mask_out: np.ndarray, pts: np.ndarray) -> None:
    """numpy twin of fill_polygon (the JAX module's Python body)."""
    if len(pts) < 3:
        if len(pts):
            mask_out[pts[:, 1], pts[:, 0]] = True
        return
    h, w = mask_out.shape
    p = pts.astype(np.float64)
    q = np.roll(p, -1, axis=0)
    ys = np.arange(max(0, int(np.floor(p[:, 1].min()))),
                   min(h - 1, int(np.ceil(p[:, 1].max()))) + 1)
    y1, y2 = p[:, 1], q[:, 1]
    x1, x2 = p[:, 0], q[:, 0]
    for y in ys:
        # edges crossing scanline y (half-open rule)
        cond = ((y1 <= y) & (y2 > y)) | ((y2 <= y) & (y1 > y))
        if not cond.any():
            continue
        t = (y - y1[cond]) / (y2[cond] - y1[cond])
        xs = x1[cond] + t * (x2[cond] - x1[cond])
        xs.sort()
        for a, b in zip(xs[0::2], xs[1::2]):
            lo = max(0, int(np.ceil(a - 0.5)))
            hi = min(w - 1, int(np.floor(b + 0.5)))
            if hi >= lo:
                mask_out[y, lo : hi + 1] = True
    # include boundary pixels explicitly (cv2 draws the outline too)
    for (ax, ay), (bx, by) in zip(p.astype(int), q.astype(int)):
        n = max(abs(bx - ax), abs(by - ay)) + 1
        xs = np.linspace(ax, bx, n).round().astype(int)
        ys_ = np.linspace(ay, by, n).round().astype(int)
        ok = (xs >= 0) & (xs < w) & (ys_ >= 0) & (ys_ < h)
        mask_out[ys_[ok], xs[ok]] = True
