"""Tendril trimming, reference-compatible API over the scan kernels.

Counterpart of image_segmenter_tpu/compat/tendril_trimming.py (reference
app/processing/tendril_trimming.py): the TendrilTrimmer class with its
alpha-sentinel protocol (NORMAL=10, H=11, V=12, BOTH=13), the
trim_tendrils convenience function, and the two backward-compatibility
methods the GUI test harness calls (in-place numpy mutation). The work runs
on the trimmer's `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from image_segmenter_tpu_torch.kernels import tendrils as K
from image_segmenter_tpu_torch.ops.color import pack_rgb_u32, unpack_rgb_u32
from image_segmenter_tpu_torch.utils.backend import resolve_device


class TendrilTrimmer:
    """(reference tendril_trimming.py:22-389)"""

    def __init__(self, device="cuda"):
        self.NORMAL_PIXEL = K.NORMAL
        self.HORIZONTAL_THIN = K.H_THIN
        self.VERTICAL_THIN = K.V_THIN
        self.BOTH_THIN = K.BOTH_THIN
        self.device = resolve_device(device)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def trim_tendrils(self, rgba: np.ndarray, threshold: int,
                      max_iterations: int = 30) -> Tuple[np.ndarray, int, str]:
        """(reference :33-71)"""
        result = rgba.copy()
        if not np.any(result[:, :, 3] > 0):
            return result, 0, "No non-transparent pixels found"
        out, iters = K.trim_tendrils_core(self._put(result), threshold,
                                          max_iterations)
        return out.cpu().numpy(), iters, f"Completed after {iters} iterations"

    # ---- harness compatibility methods (in-place mutation) ----

    def _mark_tendrils(self, rgba: np.ndarray, threshold: int) -> int:
        """(reference :73-128) Writes sentinels into rgba's alpha in place."""
        alpha, count = K.mark_tendrils_core(self._put(rgba), threshold)
        rgba[:, :, 3] = alpha.cpu().numpy()
        return int(count)

    def _process_tendrils(self, rgba: np.ndarray, threshold: int) -> None:
        """(reference :168-180) Processes pre-marked sentinels in place."""
        cid = pack_rgb_u32(self._put(rgba[:, :, :3]))
        new_cid, new_alpha = K.process_tendrils_core(
            cid, self._put(rgba[:, :, 3]), threshold)
        rgba[:, :, :3] = unpack_rgb_u32(new_cid).cpu().numpy()
        rgba[:, :, 3] = new_alpha.cpu().numpy()

    def _trim_tendrils_in_iteration(self, rgba: np.ndarray, threshold: int) -> int:
        """(reference :346-360) One mark+process iteration; returns count."""
        count = self._mark_tendrils(rgba, threshold)
        if count == 0:
            return 0
        self._process_tendrils(rgba, threshold)
        return count

    def _apply_color_selection_to_magenta(self, rgba: np.ndarray) -> int:
        """(reference :362-389) Resolve leftover marked pixels in place."""
        cid = pack_rgb_u32(self._put(rgba[:, :, :3]))
        new_cid, new_alpha, n = K.magenta_cleanup_core(
            cid, self._put(rgba[:, :, 3]))
        rgba[:, :, :3] = unpack_rgb_u32(new_cid).cpu().numpy()
        rgba[:, :, 3] = new_alpha.cpu().numpy()
        return int(n)


def trim_tendrils(rgba: np.ndarray, threshold: int,
                  max_iterations: int = 30,
                  device="cuda") -> Tuple[np.ndarray, int, str]:
    """(reference :393-406)"""
    return TendrilTrimmer(device).trim_tendrils(rgba, threshold, max_iterations)
