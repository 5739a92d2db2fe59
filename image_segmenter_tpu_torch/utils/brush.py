"""Headless brush/mask editing + preview thresholding (ImageView behaviors).

Counterpart of image_segmenter_tpu/utils/brush.py, copied: numpy in place,
no device code. The reference's canvas logic that is actually algorithmic
— disk-brush painting with stroke interpolation (image_view.py:465-515),
preview alpha binarization (:151-176) — extracted Qt-free. Brush modes
follow the user-mask convention {0=unmarked, 1=include, 2=exclude}
(image_view.py:43-44).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

MODE_VALUES = {"include": 1, "exclude": 2, "erase": 0}


def paint_disk(mask: np.ndarray, cx: int, cy: int, radius: int, value: int) -> None:
    """Rasterize a filled disk into mask in place (image_view.py:497-515)."""
    h, w = mask.shape
    x0 = max(0, cx - radius)
    y0 = max(0, cy - radius)
    x1 = min(w, cx + radius + 1)
    y1 = min(h, cy + radius + 1)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.ogrid[y0:y1, x0:x1]
    circle = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius * radius
    mask[y0:y1, x0:x1][circle] = value


def apply_brush(
    mask: np.ndarray,
    pos: Tuple[int, int],
    mode: str,
    brush_size: int = 24,
    last_pos: Optional[Tuple[int, int]] = None,
) -> None:
    """Paint a brush stamp (or an interpolated stroke segment) in place.

    Mirrors image_view.py:465-495: radius = max(1, brush_size // 2), stroke
    interpolation step = max(1, radius // 2) pixels.
    """
    if mode not in MODE_VALUES:
        return
    value = MODE_VALUES[mode]
    x, y = int(pos[0]), int(pos[1])
    radius = max(1, brush_size // 2)
    if last_pos is not None:
        lx, ly = int(last_pos[0]), int(last_pos[1])
        dx, dy = x - lx, y - ly
        dist = float(np.hypot(dx, dy))
        step_px = max(1, radius // 2)
        steps = max(1, int(dist / step_px))
        for i in range(steps + 1):
            t = i / float(steps)
            paint_disk(mask, int(round(lx + t * dx)), int(round(ly + t * dy)),
                       radius, value)
    else:
        paint_disk(mask, x, y, radius, value)


def process_alpha_for_preview(rgba: np.ndarray, opacity_threshold: int = 128) -> np.ndarray:
    """Binarize alpha for preview: >threshold -> 255, <=threshold -> 0
    (image_view.py:151-176; default threshold 128, bg_tools_panel.py:63-66)."""
    out = rgba.copy()
    above = out[:, :, 3] > opacity_threshold
    out[above, 3] = 255
    out[~above, 3] = 0
    return out
