"""Median-cut and "octree" quantizers.

Counterpart of image_segmenter_tpu/compat/_quantize_extra.py. Median cut
replaces PIL's Image.quantize(method=MEDIANCUT), which both "median_cut"
and "octree" call in the reference (color_simplify.py:145 and :201: the
reference's octree is literally median cut). The device does the heavy
lifting (the unique-colour table, the final pixel map by binary search);
the box-split loop runs on the host over at most 65,536 unique colours.

Not PIL-bit-exact: this is classical Heckbert median cut (split the most
populated box along its longest axis at the weighted median).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from image_segmenter_tpu_torch.ops import color as C
from image_segmenter_tpu_torch.ops import unique as U
from image_segmenter_tpu_torch.utils.backend import resolve_device

_CAP = 1 << 16


def _validate_rgba(rgba: np.ndarray) -> None:
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError("rgba must be HxWx4 uint8")


def _to_device(rgba: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rgba)).to(dev)


def _median_cut_boxes(colors: np.ndarray, counts: np.ndarray, k: int) -> np.ndarray:
    """Heckbert median cut on unique colors. Returns box label per color."""
    n = len(colors)
    labels = np.zeros(n, dtype=np.int32)
    boxes = {0: np.arange(n)}
    next_label = 1
    while len(boxes) < k:
        # Split the box with the largest pixel population that is splittable.
        order = sorted(boxes, key=lambda b: -counts[boxes[b]].sum())
        split_done = False
        for b in order:
            idx = boxes[b]
            if len(idx) < 2:
                continue
            sub = colors[idx].astype(np.int32)
            widths = sub.max(axis=0) - sub.min(axis=0)
            axis = int(np.argmax(widths))
            if widths[axis] == 0:
                continue
            srt = idx[np.argsort(sub[:, axis], kind="stable")]
            csum = np.cumsum(counts[srt])
            half = csum[-1] / 2.0
            cut = int(np.searchsorted(csum, half)) + 1
            cut = min(max(cut, 1), len(srt) - 1)
            boxes[b] = srt[:cut]
            boxes[next_label] = srt[cut:]
            labels[srt[cut:]] = next_label
            next_label += 1
            split_done = True
            break
        if not split_done:
            break
    # Relabel compactly in box order
    remap = {b: i for i, b in enumerate(sorted(boxes))}
    for b, idx in boxes.items():
        labels[idx] = remap[b]
    return labels, len(boxes)


def _map_via_unique(rgba: torch.Tensor, uniq_vals: torch.Tensor,
                    color_label: torch.Tensor, palette_u8: torch.Tensor,
                    zero_transparent: bool = False) -> torch.Tensor:
    """Map each pixel to palette[label(its unique colour)] by binary
    search; `zero_transparent` blanks the pixels of alpha 0."""
    h, w = rgba.shape[:2]
    packed = C.pack_rgb_u32(rgba[..., :3]).reshape(-1)
    pos = torch.searchsorted(uniq_vals, packed)
    pos = torch.clamp(pos, 0, uniq_vals.shape[0] - 1)
    mapped = palette_u8[color_label[pos]]
    if zero_transparent:
        nt = rgba[..., 3].reshape(-1) > 0
        mapped = torch.where(nt[:, None], mapped, torch.zeros_like(mapped))
    return mapped.reshape(h, w, 3)


def _alpha_out_np(alpha: np.ndarray, preserve: bool) -> np.ndarray:
    return alpha if preserve else ((alpha > 128).astype(np.uint8) * 255)


def _median_cut_impl(rgba: np.ndarray, num_colors: int, preserve_alpha: bool,
                     pow2: bool, device) -> Tuple[np.ndarray, np.ndarray]:
    _validate_rgba(rgba)
    dev = resolve_device(device)
    if pow2:
        # reference rounds DOWN to a power of two (color_simplify.py:131)
        num_colors = 2 ** int(np.log2(num_colors))
    x = _to_device(rgba, dev)
    packed = C.pack_rgb_u32(x[..., :3]).reshape(-1)
    vals, counts, n_unique = U.packed_unique(
        packed, torch.ones_like(packed, dtype=torch.bool), cap=_CAP)
    n_unique = min(int(n_unique), _CAP)
    colors = C.unpack_rgb_u32(vals).cpu().numpy()[:n_unique]
    counts_np = counts.cpu().numpy()[:n_unique]

    k = min(num_colors, max(n_unique, 1))
    labels, n_boxes = _median_cut_boxes(colors, counts_np, k)

    # Palette: weighted mean per box
    palette = np.zeros((num_colors, 3), dtype=np.float64)
    for b in range(n_boxes):
        m = labels == b
        wsum = counts_np[m].sum()
        palette[b] = (colors[m].astype(np.float64) * counts_np[m, None]).sum(0) / max(wsum, 1)
    palette_u8 = np.clip(np.round(palette), 0, 255).astype(np.uint8)

    full_labels = np.zeros(_CAP, dtype=np.int64)
    full_labels[:n_unique] = labels
    q = _map_via_unique(x, vals, torch.from_numpy(full_labels).to(dev),
                        torch.from_numpy(palette_u8).to(dev)).cpu().numpy()
    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    return np.dstack([q, alpha]), palette_u8[:num_colors]


def simplify_colors_median_cut(rgba, num_colors=8, preserve_alpha=True,
                               device="cuda"):
    """(reference color_simplify.py:105-164; quantizes ALL pixels, incl.
    transparent ones, exactly like the PIL path does)."""
    return _median_cut_impl(rgba, num_colors, preserve_alpha, pow2=True,
                            device=device)


def simplify_colors_octree(rgba, num_colors=8, preserve_alpha=True,
                           device="cuda"):
    """The reference's "octree" is PIL MEDIANCUT (color_simplify.py:201),
    without the power-of-two rounding of the median_cut entry point."""
    return _median_cut_impl(rgba, num_colors, preserve_alpha, pow2=False,
                            device=device)


def simplify_colors_perceptual(rgba, num_colors=8, preserve_alpha=True,
                               color_tolerance=30.0, use_gpu=False,
                               max_samples=10000, device="cuda"):
    from image_segmenter_tpu_torch.compat import _perceptual as P
    return P.simplify_colors_perceptual(rgba, num_colors, preserve_alpha,
                                        color_tolerance, use_gpu, max_samples,
                                        device=device)


def simplify_colors_adaptive_distance(rgba, num_colors=8, preserve_alpha=True,
                                      similarity_threshold=25.0,
                                      device="cuda"):
    from image_segmenter_tpu_torch.compat import _perceptual as P
    return P.simplify_colors_adaptive_distance(rgba, num_colors, preserve_alpha,
                                               similarity_threshold,
                                               device=device)
