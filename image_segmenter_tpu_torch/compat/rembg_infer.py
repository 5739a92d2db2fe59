"""AI background removal — reference-compatible API.

Counterpart of image_segmenter_tpu/compat/rembg_infer.py (the reference
app's processing/rembg_infer.py): the rembg/onnxruntime stack becomes the
port's U^2-Net family (models/) behind the same public function,
`rembg_remove_bgr_to_rgba(bgr, model, target_hw, sharp_edges)`. Session
caching (per model and device, lock-guarded), RGBA normalisation,
PIL-NEAREST size normalisation and the Otsu sharp-edges post-process follow
the reference in behaviour.

Weights come from the model's rembg `.onnx` when one is found, else they
are seeded (models/registry.py): masks are then meaningless but shape-,
dtype- and contract-exact. Every model id of the reference UI runs,
ISNet (`isnet-general-use`, the UI's default) included. numpy in, numpy
out; `device` is "cuda" by default and raises when the card is absent.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from image_segmenter_tpu_torch.models import registry as REG
from image_segmenter_tpu_torch.ops import histogram as HG
from image_segmenter_tpu_torch.ops import morphology as M
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.utils.backend import resolve_device

_DEFAULT_MODEL = "u2net"  # rembg's default session when none is given

# Sessions by (model id, device) (reference rembg_infer.py:12-22)
_sessions_lock = threading.Lock()
_sessions: Dict[tuple, object] = {}


def _get_session(model: str, device="cuda"):
    dev = resolve_device(device)
    key = (model, str(dev))
    with _sessions_lock:
        sess = _sessions.get(key)
        if sess is None:
            sess = REG.new_session(model, device=dev)
            _sessions[key] = sess
        return sess


def _ensure_rgba(arr: np.ndarray) -> np.ndarray:
    """(reference :25-33)"""
    if arr.ndim != 3:
        raise ValueError("Unexpected rembg array shape")
    if arr.shape[2] == 4:
        return arr
    if arr.shape[2] == 3:
        alpha = np.where((arr[:, :, 0] | arr[:, :, 1] | arr[:, :, 2]) > 0,
                         255, 0).astype(np.uint8)
        return np.dstack([arr, alpha])
    raise ValueError("Unexpected rembg channel count")


def _resize_rgba(rgba: np.ndarray, target_hw: Tuple[int, int],
                 device="cuda") -> np.ndarray:
    """PIL-NEAREST resize preserving sharp edges (reference :36-43)."""
    th, tw = target_hw
    if rgba.shape[0] == th and rgba.shape[1] == tw:
        return rgba
    x = torch.from_numpy(np.ascontiguousarray(rgba)).to(
        resolve_device(device))
    return RZ.resize_u8(x[None], (th, tw), RZ.NEAREST_PIL)[0].cpu().numpy()


def remove(rgb: np.ndarray, session=None, device="cuda") -> np.ndarray:
    """rembg.remove-compatible cutout: RGBA with the predicted alpha.

    Multi-class heads (u2net_cloth_seg) reproduce rembg's contract: one
    cutout per garment class (upper, lower, full body), concatenated
    vertically into a 3H x W image. The reference app then NEAREST-resizes
    that back to the input size, so the squashed triple panel is the
    reference's visible behaviour, kept here. A given session runs on its
    own device; `device` picks the default session's.
    """
    if session is None:
        session = _get_session(_DEFAULT_MODEL, device)
    if getattr(session.spec, "out_ch", 1) > 1:
        masks = session.predict_class_masks(rgb)
        return np.concatenate([np.dstack([rgb, m]) for m in masks], axis=0)
    mask = session.predict_mask(rgb)
    return np.dstack([rgb, mask])


def rembg_remove_bgr_to_rgba(
    bgr: np.ndarray,
    model: Optional[str] = None,
    target_hw: Optional[Tuple[int, int]] = None,
    sharp_edges: bool = True,
    device="cuda",
) -> np.ndarray:
    """(reference :46-72)"""
    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError("bgr must be HxWx3 uint8")
    rgb = bgr[:, :, ::-1]
    if model:
        out = remove(rgb, session=_get_session(model, device))
    else:
        out = remove(rgb, device=device)
    rgba = _ensure_rgba(out)
    if target_hw is None:
        target_hw = (rgb.shape[0], rgb.shape[1])
    rgba = _resize_rgba(rgba, target_hw, device)
    if sharp_edges:
        rgba = _make_alpha_sharp(rgba, device)
    return rgba


def _make_alpha_sharp(rgba: np.ndarray, device="cuda") -> np.ndarray:
    """Otsu binarize + 3x3 ellipse close/open (reference :75-96)."""
    alpha = torch.from_numpy(np.ascontiguousarray(rgba[:, :, 3])).to(
        resolve_device(device))[None]
    binary = HG.otsu_binarize(alpha)
    se = M.structuring_element(M.ELLIPSE, (3, 3))
    opened = M.open_binary(M.close_binary(binary, se), se)
    result = rgba.copy()
    result[:, :, 3] = (opened[0].to(torch.uint8) * 255).cpu().numpy()
    return result
