"""The numpy compositor of the Qt bridge.

Counterpart of image_segmenter_tpu/utils/qt_image.py
(`composite_foreground_over_transparent`, reference qt_image.py:35-44).
The Qt conversions are not ported yet.
"""

from __future__ import annotations

import numpy as np


def composite_foreground_over_transparent(
    bgr: np.ndarray, mask01: np.ndarray
) -> np.ndarray:
    """RGBA with the mask as hard alpha: mask>0 -> 255, else 0.

    Parity: reference qt_image.py:35-44 (validation + non-uint8 mask
    binarization semantics).
    """
    ok = (
        isinstance(bgr, np.ndarray)
        and bgr.dtype == np.uint8
        and bgr.ndim == 3
        and bgr.shape[-1] == 3
    )
    if not ok:
        raise ValueError("expected an HxWx3 uint8 BGR array")
    keep = mask01 if mask01.dtype == np.uint8 else (mask01 > 0).astype(np.uint8)
    out = np.empty(bgr.shape[:2] + (4,), dtype=np.uint8)
    out[..., :3] = bgr[..., ::-1]
    out[..., 3] = keep * np.uint8(255)
    return out
