"""Portrait matting refinement — reference-compatible API.

Counterpart of image_segmenter_tpu/compat/matting_refine.py, which
re-implements the reference app's processing/matting_refine.py: the trimap
construction ladder, the >1024 px downsample/upsample wrapper, the
estimate_alpha_cf retry ladder (basic -> epsilon=1e-6/radius=1 -> float64
-> simple morphological refine), and stroke enforcement, over the port's
closed-form matting solver (solvers/matting.py).

numpy in, numpy out. Every function that computes on a device takes
`device` ("cuda" by default; it raises when the card is asked for and
absent, and never falls back to the CPU).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.ops import morphology as M
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.parallel.mesh import Mesh
from image_segmenter_tpu_torch.solvers.matting import estimate_alpha_cf, \
    solve_alpha_cf
from image_segmenter_tpu_torch.utils.backend import resolve_device, true_div


def build_trimap_from_alpha_and_strokes(
    rgba_or_rgb: np.ndarray,
    alpha_init: np.ndarray,
    user_mask: Optional[np.ndarray],
    fg_threshold: int = DEFAULTS.matting_fg_threshold,
    bg_threshold: int = DEFAULTS.matting_bg_threshold,
) -> np.ndarray:
    """Trimap {0, 0.5, 1} float64 (reference matting_refine.py:14-54)."""
    h, w = alpha_init.shape
    trimap = np.full((h, w), 0.5, dtype=np.float64)

    alpha_min, alpha_max = int(alpha_init.min()), int(alpha_init.max())
    if alpha_max - alpha_min > 50:
        trimap[alpha_init >= fg_threshold] = 1.0
        trimap[alpha_init <= bg_threshold] = 0.0
    else:
        trimap[alpha_init >= np.percentile(alpha_init, 80)] = 1.0
        trimap[alpha_init <= np.percentile(alpha_init, 20)] = 0.0

    if user_mask is not None:
        trimap[user_mask == 1] = 1.0
        trimap[user_mask == 2] = 0.0

    if (trimap == 1.0).sum() == 0 or (trimap == 0.0).sum() == 0:
        trimap[alpha_init >= 128] = 1.0
        trimap[alpha_init < 128] = 0.0
        if user_mask is not None:
            trimap[user_mask == 1] = 1.0
            trimap[user_mask == 2] = 0.0

    return trimap


def _enforce_strokes(alpha_u8: np.ndarray,
                     user_mask: Optional[np.ndarray]) -> np.ndarray:
    if user_mask is not None:
        alpha_u8[user_mask == 1] = 255
        alpha_u8[user_mask == 2] = 0
    return alpha_u8


def _check_inputs(rgb: np.ndarray, alpha_init: np.ndarray) -> None:
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("rgb must be HxWx3 uint8")
    if alpha_init.dtype != np.uint8 or alpha_init.shape[:2] != rgb.shape[:2]:
        raise ValueError("alpha_init must be HxW uint8 matching image")


def simple_alpha_refine(
    rgb: np.ndarray,
    alpha_init: np.ndarray,
    user_mask: Optional[np.ndarray],
    device="cuda",
) -> np.ndarray:
    """Morphological fallback refine (reference :57-86)."""
    dev = resolve_device(device)
    binary = torch.from_numpy(np.ascontiguousarray(alpha_init)).to(dev)[None] \
        > 128
    se = M.structuring_element(M.ELLIPSE, (3, 3))
    opened = M.open_binary(M.close_binary(binary, se), se)
    alpha_sharp = (opened[0].to(torch.uint8) * 255).cpu().numpy()
    return _enforce_strokes(alpha_sharp, user_mask)


def _resize_np(x: np.ndarray, dst_hw, method: str, dev) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)[None]
    return RZ.resize_u8(t, dst_hw, method)[0].cpu().numpy()


def refine_alpha_portrait(
    rgb: np.ndarray,
    alpha_init: np.ndarray,
    user_mask: Optional[np.ndarray],
    device="cuda",
) -> np.ndarray:
    """Closed-form matting refine with the >1024 shrink rule (reference
    :89-126): AREA down, solve, LINEAR up."""
    _check_inputs(rgb, alpha_init)
    dev = resolve_device(device)
    h, w = rgb.shape[:2]
    max_dimension = DEFAULTS.matting_max_dim
    if h > max_dimension or w > max_dimension:
        nh, nw = RZ.scale_to_max_dim(h, w, max_dimension)
        rgb_small = _resize_np(rgb, (nh, nw), RZ.AREA, dev)
        alpha_small = _resize_np(alpha_init, (nh, nw), RZ.AREA, dev)
        user_small = None
        if user_mask is not None:
            user_small = _resize_np(user_mask, (nh, nw), RZ.NEAREST_CV, dev)
        refined_small = refine_alpha_portrait_small(
            rgb_small, alpha_small, user_small, device=dev)
        return _resize_np(refined_small, (h, w), RZ.LINEAR, dev)
    return refine_alpha_portrait_small(rgb, alpha_init, user_mask, device=dev)


def refine_alpha_portrait_full_res(
    rgb: np.ndarray,
    alpha_init: np.ndarray,
    user_mask: Optional[np.ndarray] = None,
    mesh=None,
    device="cuda",
) -> np.ndarray:
    """Full-resolution matting in place of the reference's lossy >1024
    downsample: the float32 solve at the image's own size.

    mesh: a (data, space) mesh (parallel/mesh.py) whose first data group's
    space slots each solve a block of the image's rows, with ghost rows
    exchanged and the sums added across the slots
    (solvers/matting._solve_impl); other data groups would hold replicas.
    The solve then runs on the slots' devices and `device` is not read.
    Without a mesh this is the unsharded full-resolution solve on `device`
    ("cuda" by default; it raises when CUDA is absent)."""
    _check_inputs(rgb, alpha_init)
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        mesh = mesh.group(0)
        for d in mesh.devices.flat:
            resolve_device(d)
        dev = mesh.first
    else:
        dev = resolve_device(device)
    trimap = build_trimap_from_alpha_and_strokes(rgb, alpha_init, user_mask)
    img = true_div(torch.from_numpy(np.ascontiguousarray(rgb)).to(dev)
                   .to(torch.float32), 255.0)
    tri = torch.from_numpy(trimap.astype(np.float32)).to(dev)
    alpha, ok, _, _ = solve_alpha_cf(img[None], tri[None], max_iter=800,
                                     rtol=1e-5, mesh=mesh)
    if not bool(ok[0]):
        return simple_alpha_refine(rgb, alpha_init, user_mask, device=dev)
    alpha_u8 = np.clip(alpha[0].cpu().numpy().astype(np.float64) * 255.0 + 0.5,
                       0, 255).astype(np.uint8)
    return _enforce_strokes(alpha_u8, user_mask)


def refine_alpha_portrait_small(
    rgb: np.ndarray,
    alpha_init: np.ndarray,
    user_mask: Optional[np.ndarray],
    device="cuda",
) -> np.ndarray:
    """(reference :129-168) with the retry/fallback ladder intact.

    A rung that does not converge raises ValueError and the next rung
    runs. Only ValueError moves down the ladder (the JAX package catches
    Exception there): a failed kernel build or launch, a missing card or
    an exhausted device is a RuntimeError or OSError and must reach the
    caller, not be answered by a cheaper rung."""
    dev = resolve_device(device)
    trimap = build_trimap_from_alpha_and_strokes(rgb, alpha_init, user_mask)
    rgb_f = rgb.astype(np.float64) / 255.0

    def rung(**kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return estimate_alpha_cf(rgb_f, trimap, device=dev, **kw)

    try:
        alpha_refined = rung()
    except ValueError:
        try:
            alpha_refined = rung(
                laplacian_kwargs={"epsilon": 1e-6, "radius": 1})
        except ValueError:
            # Third rung (pymatting is always float64, so the reference
            # never sees the float32 failure): the same solver at the
            # reference's precision. Exactly-quantized flat images put the
            # Laplacian's constant-per-region modes below the float32
            # noise floor; float64 certifies them.
            try:
                alpha_refined = rung(x64=True)
            except ValueError as e3:
                print("Warning: Advanced portrait matting failed to "
                      f"converge. Using simple refinement. Error: {e3}")
                return simple_alpha_refine(rgb, alpha_init, user_mask,
                                           device=dev)

    # The solver clips alpha to [0,1], so the +0.5 round cannot wrap.
    alpha_u8 = np.clip((alpha_refined * 255.0 + 0.5).astype(np.uint8), 0, 255)
    return _enforce_strokes(alpha_u8, user_mask)
