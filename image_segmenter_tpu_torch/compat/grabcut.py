"""GrabCut, reference-compatible API (reference grabcut.py:9-58).

Counterpart of image_segmenter_tpu/compat/grabcut.py: numpy in, numpy out;
the solve (solvers/grabcut.grabcut_core) runs on `device`, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from image_segmenter_tpu_torch.solvers import grabcut as GC


def apply_grabcut(
    bgr_image: np.ndarray,
    rect_xywh: Optional[Tuple[int, int, int, int]] = None,
    init_mask: Optional[np.ndarray] = None,
    iterations: int = 10,
    *,
    splitmerge: Optional[bool] = None,
    device="cuda",
) -> np.ndarray:
    """Run GrabCut on a BGR image (reference grabcut.py:9-58 semantics).

    rect init: inside rect -> PR_FGD, outside -> BGD (cv2 GC_INIT_WITH_RECT).
    mask init: values clipped to {0,1,2,3} (cv2 GC_INIT_WITH_MASK).
    Returns uint8 mask {0=BGD, 1=FGD, 2=PR_BGD, 3=PR_FGD}.

    iterations: EM alternations (the reference UI's 10, config.Defaults
    .grabcut_iterations).
    splitmerge (keyword-only extension, default config.Defaults
    .grabcut_splitmerge): False reproduces the plain cv2-style alternation;
    True runs the split-merge polish (solvers/grabcut._splitmerge_polish).
    """
    if bgr_image.dtype != np.uint8 or bgr_image.ndim != 3 or bgr_image.shape[2] != 3:
        raise ValueError("bgr_image must be HxWx3 uint8 BGR")

    h, w = bgr_image.shape[:2]
    mask = np.zeros((h, w), dtype=np.uint8)
    if init_mask is not None:
        if init_mask.shape != (h, w):
            raise ValueError("init_mask shape must match image")
        mask[:] = np.clip(init_mask.astype(np.uint8), 0, 3)

    if rect_xywh is not None:
        x, y, rw, rh = (int(v) for v in rect_xywh)
        mask[:] = GC.BGD
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(w, x + rw), min(h, y + rh)
        mask[y0:y1, x0:x1] = GC.PR_FGD
    elif init_mask is None:
        raise ValueError("Either rect_xywh or init_mask must be provided")

    out = GC.grabcut_core(bgr_image, mask, iterations=int(iterations),
                          splitmerge=splitmerge, device=device)
    return out.cpu().numpy()
