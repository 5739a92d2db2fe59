"""Palette comparison metrics — the corpus-wide "palette match" contract.

Counterpart of image_segmenter_tpu/utils/palette.py, copied: numpy and
scipy on the host. K-means optima are not unique across implementations
(sklearn's own optima move between versions), so the acceptance for
palette parity vs the reference (color_simplify.py:79-84) is quality +
geometry, not equality:

- quality: our palette must quantize the image as well as the reference's
  (SSE ratio, with an absolute RMS floor for near-monochrome images where
  the u8 truncation noise dominates the tiny SSE);
- geometry: Hungarian-matched distance between palettes, mass-weighted so
  a tail cluster holding 0.1% of pixels cannot dominate the statistic.
"""

from __future__ import annotations

import numpy as np


def matched_palette_distances(a: np.ndarray, b: np.ndarray,
                              b_mass: np.ndarray | None = None):
    """Hungarian-matched palette distances: (max, mass-weighted mean).

    `a`, `b` are (Ka, 3)/(Kb, 3) float palettes; `b_mass` optionally weights
    each b-center by its cluster's pixel count for the mean.
    """
    from scipy.optimize import linear_sum_assignment

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = max(len(a), len(b))
    cost = np.full((n, n), 1e6)
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    cost[: len(a), : len(b)] = d
    r, c = linear_sum_assignment(cost)
    real = (r < len(a)) & (c < len(b))
    if not real.any():
        return float("inf"), float("inf")
    dists = d[r[real], c[real]]
    if b_mass is None:
        return float(dists.max()), float(dists.mean())
    w = np.asarray(b_mass, np.float64)[c[real]]
    return float(dists.max()), float((dists * w).sum() / max(w.sum(), 1e-12))


def palette_quality_ok(pix: np.ndarray, ours: np.ndarray, ref: np.ndarray,
                       ratio_bound: float = 1.02,
                       rms_slack: float = 0.5):
    """Quality acceptance: SSE(ours)/SSE(ref) <= ratio_bound, OR the per-
    pixel RMS penalty is below `rms_slack` u8 units (half a quantization
    step). The RMS floor matters on near-monochrome images (corpus floor
    textures span ~20 RGB units): their SSE is so small that u8-truncated
    centers swing the RATIO 0.7-1.5x while the actual per-pixel error
    difference stays far below one color level.

    Returns (ok, sse_ratio, rms_delta).
    """
    pix = np.asarray(pix, np.float64)

    def sse(centers):
        d = ((pix[:, None, :] - np.asarray(centers, np.float64)[None]) ** 2).sum(-1)
        return float(d.min(1).sum())

    s_ours, s_ref = sse(ours), sse(ref)
    ratio = s_ours / max(s_ref, 1e-9)
    n = max(len(pix), 1)
    rms_delta = np.sqrt(s_ours / n) - np.sqrt(s_ref / n)
    return (ratio <= ratio_bound or rms_delta <= rms_slack), ratio, rms_delta
