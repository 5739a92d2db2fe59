"""GrabCut seed synthesis from brush strokes + crop rect (headless).

Counterpart of image_segmenter_tpu/utils/seeds.py: the workflow logic of
MainWindow._on_run_grabcut (main_window.py:243-374) without Qt. Turn a
user stroke mask {0,1,2} and an optional crop rect into the (bgr_roi,
rect_xywh, init_mask) arguments for apply_grabcut, with the reference's
include-bbox dilation heuristics, then composite the result back onto the
full canvas. The seeds are numpy; the GrabCut solve runs on `device`, the
card unless the caller asks for the CPU. `portrait_scene` and
`config4_rect` make seeded GrabCut inputs at BASELINE config 4's shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from image_segmenter_tpu_torch.compat.grabcut import apply_grabcut
from image_segmenter_tpu_torch.utils.qt_image import \
    composite_foreground_over_transparent


def _bbox_of(mask: np.ndarray, value: int) -> Optional[Tuple[int, int, int, int]]:
    rows, cols = np.where(mask == value)
    if rows.size == 0:
        return None
    return (int(cols.min()), int(rows.min()),
            int(cols.max() - cols.min() + 1), int(rows.max() - rows.min() + 1))


def _expanded_bbox(bbox, w, h, margin):
    sx, sy, sw, sh = bbox
    sx = max(0, sx - margin)
    sy = max(0, sy - margin)
    sw = min(w - sx, sw + 2 * margin)
    sh = min(h - sy, sh + 2 * margin)
    return sx, sy, sw, sh


def grabcut_seeds(
    shape_hw: Tuple[int, int],
    user_mask: Optional[np.ndarray],
    rect_xywh: Optional[Tuple[int, int, int, int]] = None,
):
    """Build GrabCut init arguments from strokes (main_window.py:256-361).

    Returns (roi_xywh, rect_seed, init_mask) where roi_xywh is the clamped
    crop region to run on, and exactly one of rect_seed / init_mask is
    non-None — or (None, None, None) when there is nothing to seed with
    (the reference shows "Add Include marks or set a Crop rectangle first").
    """
    h_full, w_full = shape_hw
    if rect_xywh is not None:
        rx, ry, rw, rh = rect_xywh
        rx = max(0, min(rx, w_full - 1))
        ry = max(0, min(ry, h_full - 1))
        rw = max(1, min(rw, w_full - rx))
        rh = max(1, min(rh, h_full - ry))
        roi = (rx, ry, rw, rh)
        um = user_mask[ry:ry + rh, rx:rx + rw] if user_mask is not None else None
        init_mask = None
        if um is not None and ((um == 1).any() or (um == 2).any()):
            init_mask = np.zeros((rh, rw), dtype=np.uint8)
            init_mask[um == 1] = 3  # PR_FGD
            init_mask[um == 2] = 2  # PR_BGD
            bbox = _bbox_of(um, 1)
            if bbox is not None:
                margin = max(5, min(rw, rh) // 20)
                sx, sy, sw, sh = _expanded_bbox(bbox, rw, rh, margin)
                init_mask[sy:sy + sh, sx:sx + sw] = 3
        if init_mask is not None and (init_mask == 3).any():
            return roi, None, init_mask
        # rect seeding from include bbox, else inset ROI
        seed_rect = None
        if um is not None:
            bbox = _bbox_of(um, 1)
            if bbox is not None:
                margin = max(2, min(rw, rh) // 20)
                sx, sy, sw, sh = _expanded_bbox(bbox, rw, rh, margin)
                seed_rect = (sx, sy, max(1, sw), max(1, sh))
        if seed_rect is None:
            seed_rect = (1, 1, max(1, rw - 2), max(1, rh - 2))
        return roi, seed_rect, None

    # full image
    roi = (0, 0, w_full, h_full)
    if user_mask is None or not (user_mask != 0).any():
        return None, None, None
    init_mask = np.zeros((h_full, w_full), dtype=np.uint8)
    init_mask[user_mask == 1] = 3
    init_mask[user_mask == 2] = 2
    bbox = _bbox_of(user_mask, 1)
    if bbox is not None:
        margin = max(10, min(w_full, h_full) // 20)
        sx, sy, sw, sh = _expanded_bbox(bbox, w_full, h_full, margin)
        init_mask[sy:sy + sh, sx:sx + sw] = 3
    if (init_mask == 3).any():
        return roi, None, init_mask
    bbox = _bbox_of(user_mask, 1)
    if bbox is not None:
        margin = max(2, min(w_full, h_full) // 20)
        sx, sy, sw, sh = _expanded_bbox(bbox, w_full, h_full, margin)
        return roi, (sx, sy, max(1, sw), max(1, sh)), None
    return None, None, None


def run_grabcut_workflow(
    bgr_full: np.ndarray,
    user_mask: Optional[np.ndarray] = None,
    rect_xywh: Optional[Tuple[int, int, int, int]] = None,
    iterations: int = 10,
    device="cuda",
) -> Optional[np.ndarray]:
    """Full _on_run_grabcut flow: seeds -> apply_grabcut -> RGBA composite.

    Returns the RGBA cutout over transparency, or None when unseeded
    (main_window.py:363-371).
    """
    h_full, w_full = bgr_full.shape[:2]
    roi, seed_rect, init_mask = grabcut_seeds((h_full, w_full), user_mask, rect_xywh)
    if roi is None:
        return None
    rx, ry, rw, rh = roi
    bgr = bgr_full[ry:ry + rh, rx:rx + rw]
    gc_roi = apply_grabcut(bgr, rect_xywh=seed_rect, init_mask=init_mask,
                           iterations=iterations, device=device)
    gc_mask = np.zeros((h_full, w_full), dtype=np.uint8)
    gc_mask[ry:ry + rh, rx:rx + rw] = gc_roi
    fg01 = ((gc_mask == 1) | (gc_mask == 3)).astype(np.uint8)
    return composite_foreground_over_transparent(bgr_full, fg01)


# --------------------------------------------------------------------------
# seeded scenes: GrabCut inputs for the card checks and the profiler
# --------------------------------------------------------------------------

def portrait_scene(h: int, w: int, seed: int):
    """A seeded portrait: a textured subject (head and torso) over a
    textured background, plus noise. Returns (BGR u8, subject mask)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, 6)
    bg = np.stack([110 + 60 * np.sin(xx / (0.07 * w) + ph[0])
                   * np.cos(yy / (0.09 * h) + ph[1]),
                   120 + 50 * np.cos((xx + yy) / (0.11 * w) + ph[2]),
                   90 + 40 * np.sin(yy / (0.05 * h) + ph[3])], axis=-1)
    torso = (((yy - 0.78 * h) / (0.34 * h)) ** 2
             + ((xx - 0.5 * w) / (0.3 * w)) ** 2) < 1
    head = np.hypot((yy - 0.33 * h) / (0.15 * h),
                    (xx - 0.5 * w) / (0.15 * h)) < 1
    subject = torso | head
    fg = np.stack([60 + 25 * np.sin(yy / (0.02 * h) + ph[4]),
                   70 + 20 * np.cos(xx / (0.03 * w) + ph[5]),
                   180 + 30 * np.sin((xx - yy) / (0.04 * w))], axis=-1)
    img = np.where(subject[..., None], fg, bg) + rng.normal(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8), subject


def config4_rect(h: int, w: int):
    """BASELINE config 4's GrabCut rect (x, y, w, h) for an h x w crop."""
    return (w // 8, h // 12, w * 3 // 4, h * 9 // 10)
