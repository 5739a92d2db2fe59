"""Canny edge detection with cv2.Canny's bits.

Counterpart of image_segmenter_tpu/ops/edges.py: the reference's third
boundary fallback, cv2.Canny(gray, 5, 15) (region_cleanup.py:728-739).
OpenCV's pipeline (aperture 3, L1 gradient) in int32 tensor ops:
replicate-padded Sobel, fixed-point sector quantisation for non-maximum
suppression (OpenCV's 2^15-scaled tan(22.5) arithmetic with its exact
strict and non-strict neighbour comparisons), and hysteresis as
connected-component reachability (label the NMS survivors above the low
threshold, keep the components that hold a pixel above the high one).
Integer work only, so every device gives the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from image_segmenter_tpu_torch.ops import connected_components as CCOMP
from image_segmenter_tpu_torch.utils.backend import resolve_device

_CANNY_SHIFT = 15
_TG22 = 13573  # round(tan(22.5 deg) * 2^15), OpenCV's constant


def _sobel_pair(gray: torch.Tensor):
    """Aperture-3 Sobel dx/dy, int32. cv2.Canny invokes Sobel with
    BORDER_REPLICATE (unlike standalone cv2.Sobel's reflect-101 default)."""
    h, w = gray.shape
    dev = gray.device
    rows = torch.clamp(torch.arange(-1, h + 1, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 1, device=dev), 0, w - 1)
    p = gray.to(torch.int32)[rows][:, cols]

    def sl(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (sl(-1, 1) + 2 * sl(0, 1) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(0, -1) - sl(1, -1))
    gy = (sl(1, -1) + 2 * sl(1, 0) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(-1, 0) - sl(-1, 1))
    return gx, gy


def _nms(mag: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """OpenCV's sector-quantized non-maximum suppression.

    Keep pixel m when it strictly beats the 'previous' neighbor and ties or
    beats the 'next' neighbor along the quantized gradient direction;
    out-of-image magnitudes are 0 (OpenCV zero-pads its row buffers).
    """
    h, w = mag.shape
    mp = torch.nn.functional.pad(mag, (1, 1, 1, 1), value=0)

    def sl(dy, dx):
        return mp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    x = torch.abs(gx)
    y = torch.abs(gy) << _CANNY_SHIFT
    tg22x = x * _TG22
    tg67x = tg22x + (x << (_CANNY_SHIFT + 1))

    horiz = y < tg22x
    vert = y > tg67x
    # diagonal sector: sign(gx) == sign(gy) -> 135 deg, opposite -> 45 deg
    s_neg = (gx ^ gy) < 0
    diag_prev = torch.where(s_neg, sl(-1, 1), sl(-1, -1))
    diag_next = torch.where(s_neg, sl(1, -1), sl(1, 1))

    prev_m = torch.where(horiz, sl(0, -1), torch.where(vert, sl(-1, 0), diag_prev))
    next_m = torch.where(horiz, sl(0, 1), torch.where(vert, sl(1, 0), diag_next))
    # the axis sectors compare (strict prev, non-strict next); the diagonal
    # sector is strict against both neighbours (cv2 5.0, tests/test_edges.py)
    axis_keep = (mag > prev_m) & (mag >= next_m)
    diag_keep = (mag > prev_m) & (mag > next_m)
    return torch.where(horiz | vert, axis_keep, diag_keep)


def canny_core(gray: torch.Tensor, low: float, high: float,
               l2gradient: bool = False) -> torch.Tensor:
    """(H, W) uint8 gray -> (H, W) uint8 {0, 255} edges on gray's device."""
    gx, gy = _sobel_pair(gray)
    if l2gradient:
        # OpenCV squares the thresholds in L2 mode; keep ints exact
        mag = gx * gx + gy * gy
        lo, hi = int(low) * int(low), int(high) * int(high)
    else:
        mag = torch.abs(gx) + torch.abs(gy)
        lo, hi = int(low), int(high)

    keep = _nms(mag, gx, gy)
    cand = keep & (mag > lo)
    strong = cand & (mag > hi)

    # hysteresis: candidates 8-connected to a strong pixel survive
    labels = CCOMP.label_components(torch.zeros_like(gray, dtype=torch.int32),
                                    cand, 8)
    h, w = gray.shape
    flat = torch.where(cand.reshape(-1), labels.reshape(-1).to(torch.int64), 0)
    seed = torch.zeros(h * w, dtype=torch.int32, device=gray.device)
    seed.scatter_reduce_(0, flat, strong.reshape(-1).to(torch.int32), "amax")
    edge = cand & (seed[flat].reshape(h, w) > 0)
    return edge.to(torch.uint8) * 255


def canny(gray, threshold1: float, threshold2: float,
          l2gradient: bool = False, device="cuda"):
    """cv2.Canny-compatible entry: uint8 gray in, {0,255} uint8 out (numpy),
    computed on `device`."""
    dev = resolve_device(device)
    lo, hi = sorted((float(threshold1), float(threshold2)))
    g = torch.as_tensor(np.ascontiguousarray(gray), device=dev)
    return canny_core(g, lo, hi, l2gradient=l2gradient).cpu().numpy()
