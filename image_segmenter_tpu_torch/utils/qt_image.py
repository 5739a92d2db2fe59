"""Qt <-> numpy bridge.

Counterpart of image_segmenter_tpu/utils/qt_image.py, copied: no device
code. Behavior parity with the reference bridge (app/utils/qt_image.py:
9-44): three conversions between Qt images and the framework's canonical
uint8 array contracts (HxWx3 BGR in, HxWx4 RGBA out). PySide6 is imported
lazily, after the input checks, so headless deployments never need Qt;
the pure-numpy compositor works everywhere.
"""

from __future__ import annotations

import numpy as np

_RGBA_FORMAT = "Format_RGBA8888"


def _rgba_format():
    from PySide6.QtGui import QImage  # noqa: PLC0415

    return QImage, getattr(QImage.Format, _RGBA_FORMAT)


def qimage_to_numpy_bgr(qimg) -> np.ndarray:
    """Decode any QImage into an owned HxWx3 uint8 BGR array.

    Parity: reference qt_image.py:9-22. Route everything through one
    canonical RGBA8888 layout, view the backing store once, then drop the
    alpha plane and flip channel order to BGR.
    """
    _, rgba8888 = _rgba_format()
    canonical = qimg if qimg.format() == rgba8888 else qimg.convertToFormat(rgba8888)
    height, width = canonical.height(), canonical.width()
    flat = np.frombuffer(canonical.constBits(), dtype=np.uint8)
    rgba = flat.reshape(height, width, 4)
    # Owned copy: the QImage buffer dies with `canonical`.
    return np.ascontiguousarray(rgba[..., 2::-1])


def numpy_rgba_to_qimage(rgba: np.ndarray):
    """Wrap an HxWx4 uint8 RGBA array as an owned QImage.

    Parity: reference qt_image.py:25-32 (including the validation error on
    non-conforming input).
    """
    ok = (
        isinstance(rgba, np.ndarray)
        and rgba.dtype == np.uint8
        and rgba.ndim == 3
        and rgba.shape[-1] == 4
    )
    if not ok:
        raise ValueError("expected an HxWx4 uint8 RGBA array")
    QImage, rgba8888 = _rgba_format()
    height, width = rgba.shape[:2]
    contiguous = np.ascontiguousarray(rgba)
    # .copy() detaches the QImage from the numpy buffer's lifetime.
    return QImage(contiguous.data, width, height, rgba8888).copy()


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
