"""Behavioral port of the GUI test harness's boundary smoother.

Counterpart of image_segmenter_tpu/compat/harness.py. The reference's
interactive comparison tool implements a majority-vote boundary smoother
that exists ONLY in the harness, not in app/processing
(test_smoothing_algorithms.py:1025-1186), with its convergence ladder:
no-change stop, oscillation detection over the last 20 change rates, a 30 s
wall-clock timeout, and a >50%-changed runaway guard when tendril trimming
is interleaved. The ladder reads each iteration's count, so the loop reads
the card once an iteration.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from image_segmenter_tpu_torch.compat import _smoothing as S
from image_segmenter_tpu_torch.compat.tendril_trimming import TendrilTrimmer, trim_tendrils
from image_segmenter_tpu_torch.kernels.majority import majority_step
from image_segmenter_tpu_torch.ops import morphology as M
from image_segmenter_tpu_torch.ops.color import pack_rgb_u32, unpack_rgb_u32
from image_segmenter_tpu_torch.utils.backend import resolve_device


def apply_custom_morphological_smoothing(
    rgba: np.ndarray,
    kernel_size: int,
    kernel_shape: str = "Ellipse",
    operation: str = "Open then Close",
    strength: float = 1.0,
    preserve_colors: bool = True,
    device="cuda",
) -> np.ndarray:
    """The harness's parameterized morphological fine-tuning tab
    (test_smoothing_algorithms.py:874-929): per-color open/close sequences
    with addWeighted strength blending. With 0 < strength < 0.998 the blend's
    ">0" test makes the covered set the UNION of the original and processed
    masks (both weighted terms round to nonzero) — semantics preserved.
    Colours are written in ascending order, last write wins, so they run as
    batches (compat/_smoothing.last_cover).
    """
    result = rgba.copy()
    nt = result[:, :, 3] > 0
    if not nt.any():
        return result

    shape = {"Ellipse": M.ELLIPSE, "Rectangle": M.RECT}.get(kernel_shape, M.CROSS)
    se = M.structuring_element(shape, (kernel_size, kernel_size))
    w1 = round(255.0 * (1.0 - strength))  # addWeighted term of the original
    w2 = round(255.0 * strength)

    def seq(mask):
        if operation == "Open then Close":
            return M.close_binary(M.open_binary(mask, se), se)
        if operation == "Close then Open":
            return M.open_binary(M.close_binary(mask, se), se)
        if operation == "Open only":
            return M.open_binary(mask, se)
        return M.close_binary(mask, se)  # "Close only"

    def covered(mask):
        blend = w1 * mask.to(torch.int32) + w2 * seq(mask).to(torch.int32)
        return blend > 0

    x = torch.as_tensor(result, device=resolve_device(device))
    vals, n = S.color_table(x)
    best = S.last_cover(pack_rgb_u32(x[:, :, :3]), x[:, :, 3] > 0, vals,
                        list(range(n)), covered)
    return S.recolor(x, best, vals, keep_uncovered=True).cpu().numpy()


def compare_smoothing_algorithms(rgba: np.ndarray, strength: float = 0.5,
                                 device="cuda"):
    """The harness's algorithm-comparison tab (test_smoothing_algorithms.py:
    178-223): run all five smooth_region_boundaries methods, timing each;
    an algorithm that raises contributes an input copy (the harness's
    fallback-on-exception oracle, :218-221).

    Returns {method: (result_rgba, seconds)}.
    """
    from image_segmenter_tpu_torch.compat.region_cleanup import smooth_region_boundaries

    results = {}
    for method in ("morphological", "bilateral", "contour", "gaussian",
                   "multiscale"):
        t0 = time.time()
        try:
            out = smooth_region_boundaries(rgba, method=method,
                                           strength=strength, device=device)
        except Exception:
            out = rgba.copy()
        results[method] = (out, time.time() - t0)
    return results


def apply_boundary_smoothing_global(
    rgba: np.ndarray,
    max_iterations: Optional[int] = None,
    trim_tendrils_flag: bool = False,
    tendril_threshold: int = 2,
    progress_callback: Optional[Callable[[int, int, str], None]] = None,
    timeout_s: float = 30.0,
    device="cuda",
) -> np.ndarray:
    """Iterative 4-neighbor majority smoothing with the harness's guards.

    max_iterations=None reproduces unlimited_iterations=True (cap 1000,
    test_smoothing_algorithms.py:1047-1050).
    """
    result = rgba.copy()
    alpha = result[:, :, 3]
    non_transparent = alpha > 0
    if not np.any(non_transparent):
        return result

    dev = resolve_device(device)
    cap = 1000 if max_iterations is None else int(max_iterations)
    total_pixels = int(non_transparent.sum())
    cid = pack_rgb_u32(torch.as_tensor(result[:, :, :3], device=dev))
    opaque = torch.as_tensor(non_transparent, device=dev)

    trimmer = TendrilTrimmer(dev)
    changes_history = []
    start = time.time()
    iteration = 0
    while iteration < cap:
        cid, applied, _ = majority_step(cid, opaque)
        pixels_changed = int(applied)
        changes_made = pixels_changed > 0

        if trim_tendrils_flag:
            result[:, :, :3] = unpack_rgb_u32(cid).cpu().numpy()
            removed = trimmer._trim_tendrils_in_iteration(result, tendril_threshold)
            if removed > 0:
                changes_made = True
                pixels_changed += removed
                pixels_changed += trimmer._apply_color_selection_to_magenta(result)
            cid = pack_rgb_u32(torch.as_tensor(result[:, :, :3], device=dev))

        iteration += 1
        pct = (pixels_changed / total_pixels) * 100 if total_pixels else 0.0
        changes_history.append(pct)
        if progress_callback:
            progress_callback(iteration, cap,
                              f"Iteration {iteration}: {pixels_changed} pixels changed "
                              f"({pct:.1f}%)")

        if not changes_made:
            break
        if len(changes_history) >= 20:
            recent = changes_history[-20:]
            if len({round(x, 1) for x in recent}) <= 2:
                break  # oscillation (reference :1153-1159)
        if time.time() - start > timeout_s:
            break
        if trim_tendrils_flag and pixels_changed > total_pixels * 0.5:
            break
        if len(changes_history) > 20:
            changes_history = changes_history[-20:]

    result[:, :, :3] = unpack_rgb_u32(cid).cpu().numpy()

    if trim_tendrils_flag:
        result, _, _ = trim_tendrils(result, tendril_threshold,
                                     max_iterations=30, device=dev)
    return result
