"""Colour quantizer suite — reference-compatible API over the port's solvers.

Counterpart of image_segmenter_tpu/compat/color_simplify.py, which
re-implements the reference app's processing/color_simplify.py with the
same public signatures and semantics:

- kmeans            -> solvers.kmeans.kmeans_fit over deduplicated colours
- median_cut/octree -> compat._quantize_extra (the reference's "octree" IS
                       median cut, color_simplify.py:201)
- threshold         -> elementwise posterize
- perceptual        -> solvers.agglomerative (exact Ward) in LAB
- perceptual_fast   -> k-means in LAB on downsampled unique colours
- adaptive_distance -> solvers.dbscan + k-means
- hsv_clustering    -> k-means on weighted OpenCV-convention HSV
- custom_palette    -> nearest-neighbour map in lab / rgb / hsv space

numpy in, numpy out. Every function that computes on a device takes
`device` ("cuda" by default; it raises when the card is asked for and
absent, and never falls back to the CPU).

Reference bugs are fixed by default and reproducible with bug_compat=True
(config.Defaults.bug_compat): the kmeans chained-fancy-index no-op that
leaves the output RGB black (color_simplify.py:90), and perceptual's map
of LAB pixels against RGB cluster centres (color_simplify.py:544).

The reference samples pixels with an unseeded np.random.choice; here the
samples are seeded with Defaults.kmeans_seed through utils/prng (the JAX
package's stream), so results are reproducible and the two packages make
the same draws.

The palette maps are plain PyTorch (`solvers.kmeans.assign_labels`), as
the JAX package computes them outside any Pallas kernel: kernel K4's
arithmetic (direct differences, (r+g+b) * 1/3) is not theirs.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from image_segmenter_tpu_torch.compat import _perceptual as P
from image_segmenter_tpu_torch.compat import _quantize_extra as QX
from image_segmenter_tpu_torch.compat._quantize_extra import (
    _alpha_out_np, _to_device, _validate_rgba)
from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.ops import color as C
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.ops import unique as U
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils.backend import resolve_device, true_div

_UNIQUE_CAP = 1 << 16

# Stage attribution of the most recent hsv_clustering call (seconds per
# stage on the host clock, each stamp taken after a device-to-host read;
# same convention as solvers/matting.LAST_SOLVE_INFO).
LAST_SOLVE_INFO: dict = {}


def _fallback(rgba: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's no-op return: (original, [[0,0,0]])."""
    return rgba, np.array([[0, 0, 0]])


# --------------------------------------------------------------------------
# device cores
# --------------------------------------------------------------------------

def _filter_ladder(nt: torch.Tensor, level: torch.Tensor, packed: torch.Tensor,
                   num_colors: int):
    """The black-filter ladder (color_simplify.py:54-64): the pixels of
    `level` > 30 if there are at least `num_colors`, else those > 10 if
    any, else every non-transparent pixel. Returns (fit_mask, n_unique,
    n_fit), or None when every pixel is transparent. One host read."""
    b30 = nt & (level > 30)
    b10 = nt & (level > 10)
    n_nt, n_b30, n_b10, u30, u10, u_all = torch.stack(
        [t.to(torch.int64) for t in (
            nt.sum(), b30.sum(), b10.sum(), U.count_unique(packed, b30),
            U.count_unique(packed, b10), U.count_unique(packed, nt))]).tolist()
    if n_nt == 0:
        return None
    if n_b30 >= num_colors:
        return b30, u30, n_b30
    if n_b10 > 0:
        return b10, u10, n_b10
    return nt, u_all, n_nt


def _fit(points: torch.Tensor, weights: torch.Tensor, k: int,
         max_iter: int = 300) -> torch.Tensor:
    return KM.kmeans_fit(points.to(torch.float32), weights, k,
                         n_init=DEFAULTS.kmeans_n_init, max_iter=max_iter,
                         seed=DEFAULTS.kmeans_seed).centers


def _kmeans_fit_rgb(rgb: torch.Tensor, packed: torch.Tensor,
                    fit_mask: torch.Tensor, k: int) -> torch.Tensor:
    """Weighted k-means over DEDUPLICATED colours: the same fit as over the
    pixels (weighted Lloyd == Lloyd on repeats; count * D^2 sampling ==
    pixel-level D^2 sampling) at a fraction of the work on photographs.
    Past the table's capacity the pixels themselves are fitted."""
    vals, counts, n_unique = U.packed_unique(packed, fit_mask, cap=_UNIQUE_CAP)
    if int(n_unique) <= _UNIQUE_CAP:
        centers = _fit(C.unpack_rgb_u32(vals), counts, k)
    else:
        centers = _fit(rgb, fit_mask.to(torch.float32), k)
    return torch.clamp(centers, 0, 255).to(torch.uint8)


def _hsv_normalized(hsv: torch.Tensor) -> torch.Tensor:
    """Normalisation + importance weights (color_simplify.py:969-981)."""
    return torch.stack(
        [true_div(hsv[..., 0], 179.0) * 2.0,
         true_div(hsv[..., 1], 255.0) * 1.5,
         true_div(hsv[..., 2], 255.0)], dim=-1)


def _cluster_mean_rgb(points: torch.Tensor, rgb: torch.Tensor,
                      weights: torch.Tensor, centers: torch.Tensor, k: int):
    """Per-cluster weighted mean of rgb for the points assigned to each
    centre. The sums add integers (u8 colours, 0/1 weights) in float64:
    exact in any order."""
    labels = KM.assign_labels(points[None], centers[None])[0]
    w = weights.to(torch.float64)
    sums = torch.zeros((k, 3), dtype=torch.float64, device=points.device)
    sums.index_add_(0, labels, rgb.to(torch.float64) * w[:, None])
    cnts = torch.zeros((k,), dtype=torch.float64, device=points.device)
    cnts.index_add_(0, labels, w)
    mean = sums.to(torch.float32) / torch.clamp_min(cnts.to(torch.float32),
                                                    1.0)[:, None]
    return mean, labels


# --------------------------------------------------------------------------
# Public API (reference signatures, plus `device`)
# --------------------------------------------------------------------------

def simplify_colors_kmeans(
    rgba: np.ndarray,
    num_colors: int = 8,
    preserve_alpha: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """K-means color simplification (reference color_simplify.py:12-102)."""
    _validate_rgba(rgba)
    dev = resolve_device(device)
    x = _to_device(rgba, dev)
    rgb = x[..., :3].reshape(-1, 3)
    nt = x[..., 3].reshape(-1) > 0
    # the mean of three as a true division of their (exact) sum: a CUDA
    # mean multiplies by 1/3, which rounds 90/3 above the threshold of 30
    f = rgb.to(torch.float32)
    brightness = true_div((f[:, 0] + f[:, 1]) + f[:, 2], 3.0)
    packed = C.pack_rgb_u32(rgb)
    rung = _filter_ladder(nt, brightness, packed, num_colors)
    if rung is None:
        return _fallback(rgba)
    fit_mask, n_unique, _ = rung

    actual_k = min(num_colors, n_unique)
    if actual_k < 2:
        return _fallback(rgba)

    centers = _kmeans_fit_rgb(rgb, packed, fit_mask, actual_k)

    if DEFAULTS.bug_compat:
        # Reproduce the chained fancy-index no-op: RGB output stays black
        # (color_simplify.py:90), palette is still correct.
        quantized_rgb = np.zeros_like(rgba[..., :3])
    else:
        # fit-mask pixels -> nearest centre; the others stay black
        quantized_rgb = P.map_nearest(
            rgb.to(torch.float32), centers, centers, fit_mask,
            rgba.shape[:2]).cpu().numpy()

    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    return np.dstack([quantized_rgb, alpha]), centers.cpu().numpy()


def simplify_colors_threshold(
    rgba: np.ndarray,
    num_colors: int = 8,
    preserve_alpha: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Posterization (reference color_simplify.py:223-277):
    (rgb // step) * step with step = 256 // levels."""
    _validate_rgba(rgba)
    dev = resolve_device(device)
    levels = int(np.ceil(np.cbrt(num_colors)))
    step = 256 // levels
    x = _to_device(rgba, dev)
    q = torch.div(x[..., :3], step, rounding_mode="floor") * step
    packed = C.pack_rgb_u32(q).reshape(-1)
    vals, _, n = U.packed_unique(
        packed, torch.ones_like(packed, dtype=torch.bool), cap=4096)
    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    simplified = np.dstack([q.cpu().numpy(), alpha])
    palette = C.unpack_rgb_u32(vals[: min(int(n), num_colors)]).cpu().numpy()
    return simplified, palette


def simplify_colors_hsv_clustering(
    rgba: np.ndarray,
    num_colors: int = 8,
    preserve_alpha: bool = True,
    hue_tolerance: float = 15.0,
    saturation_tolerance: float = 0.2,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """HSV-weighted k-means (reference color_simplify.py:885-1036)."""
    _validate_rgba(rgba)
    dev = resolve_device(device)
    LAST_SOLVE_INFO.clear()
    t0 = time.perf_counter()
    x = _to_device(rgba, dev)
    rgb = x[..., :3].reshape(-1, 3)
    nt = x[..., 3].reshape(-1) > 0
    hsv = C.rgb_u8_to_hsv_cv(rgb)
    hsv_n = _hsv_normalized(hsv)
    # The reference counts unique *weighted-HSV* vectors (:984); unique RGB
    # is an equivalent proxy for the k >= 2 guard (HSV is a function of RGB).
    rung = _filter_ladder(nt, hsv[..., 2], C.pack_rgb_u32(rgb), num_colors)
    if rung is None:
        return _fallback(rgba)
    fit_mask, n_unique, n_fit = rung
    # the ladder's host read fences the ingest, the masks and the counts
    LAST_SOLVE_INFO["t_ingest_masks"] = time.perf_counter() - t0

    actual_k = min(num_colors, n_unique)
    if actual_k < 2:
        return _fallback(rgba)

    t0 = time.perf_counter()
    wts = fit_mask.to(torch.float32)
    centers_hsv = _fit(hsv_n, wts, actual_k)
    centers_hsv.cpu()  # host fence
    LAST_SOLVE_INFO["t_fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # RGB-space cluster centres = mean RGB of members (:996-1002)
    centers_rgb, labels = _cluster_mean_rgb(hsv_n, rgb, wts, centers_hsv,
                                            actual_k)
    centers_u8 = torch.clamp(centers_rgb, 0, 255).to(torch.uint8)
    # Black (filtered-out) pixels -> nearest centre in RGB (:1016-1021)
    rgb_labels = KM.assign_labels(rgb.to(torch.float32)[None],
                                  centers_u8.to(torch.float32)[None])[0]
    mapped = centers_u8[torch.where(fit_mask, labels, rgb_labels)]
    out = torch.where(nt[:, None], mapped, torch.zeros_like(mapped))
    quantized_rgb = out.reshape(*rgba.shape[:2], 3).cpu().numpy()
    LAST_SOLVE_INFO["t_map_d2h"] = time.perf_counter() - t0
    LAST_SOLVE_INFO["n_fit_points"] = n_fit
    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    return np.dstack([quantized_rgb, alpha]), centers_u8.cpu().numpy()


def simplify_colors_perceptual_fast(
    rgba: np.ndarray,
    num_colors: int = 8,
    preserve_alpha: bool = True,
    color_tolerance: float = 30.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """LAB k-means over downsampled unique colors (color_simplify.py:562-707)."""
    _validate_rgba(rgba)
    dev = resolve_device(device)
    h, w = rgba.shape[:2]
    x = _to_device(rgba, dev)
    if int((x[..., 3] > 0).sum()) == 0:
        return _fallback(rgba)

    # Downsample to <= 512 max-dim with INTER_AREA (:608-614)
    max_dim = DEFAULTS.perceptual_fast_max_dim
    if h > max_dim or w > max_dim:
        nh, nw = RZ.scale_to_max_dim(h, w, max_dim)
        rgb_small = RZ.resize_u8(x[None, ..., :3], (nh, nw), RZ.AREA)[0]
        alpha_small = RZ.resize_u8(x[None, ..., 3], (nh, nw), RZ.AREA)[0]
        if int((alpha_small > 0).sum()) == 0:
            return _fallback(rgba)
    else:
        rgb_small, alpha_small = x[..., :3], x[..., 3]

    # Unique colors among a <=5000-pixel sample (:632-640), sampled with a
    # fixed seed (the reference's np.random is unseeded).
    sampled = P.seeded_sample_mask(alpha_small.reshape(-1) > 0,
                                   DEFAULTS.perceptual_fast_max_samples)
    vals, _, n_unique = U.packed_unique(
        C.pack_rgb_u32(rgb_small.reshape(-1, 3)), sampled, cap=8192)
    uniq = C.unpack_rgb_u32(vals).cpu().numpy()[: int(n_unique)]

    # black filter on unique colors (:644-654)
    bright = uniq.astype(np.float64).mean(axis=1)
    mask = bright > 30
    if mask.sum() < num_colors:
        mask = bright > 10
    if mask.sum() == 0:
        mask = np.ones(len(uniq), dtype=bool)
    filt = uniq[mask]

    actual_k = min(num_colors, len(filt))
    if actual_k < 2:
        return _fallback(rgba)

    lab = C.rgb_u8_to_lab(torch.from_numpy(filt).to(dev))
    centers_lab = _fit(lab, torch.ones((len(filt),), device=dev), actual_k,
                       max_iter=100)
    centers_rgb = C.lab_to_rgb_u8(centers_lab)

    # Map all full-res non-transparent pixels in LAB space (:684-695)
    rgb = x[..., :3].reshape(-1, 3)
    quantized_rgb = P.map_nearest(
        C.rgb_u8_to_lab(rgb), centers_lab, centers_rgb,
        x[..., 3].reshape(-1) > 0, (h, w)).cpu().numpy()
    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    return np.dstack([quantized_rgb, alpha]), centers_rgb.cpu().numpy()


def simplify_colors_custom_palette(
    rgba: np.ndarray,
    custom_palette: np.ndarray,
    preserve_alpha: bool = True,
    distance_metric: str = "lab",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-palette mapping (reference color_simplify.py:1039-1123)."""
    _validate_rgba(rgba)
    if custom_palette.dtype != np.uint8 or custom_palette.ndim != 2 or custom_palette.shape[1] != 3:
        raise ValueError("custom_palette must be Nx3 uint8")
    dev = resolve_device(device)
    x = _to_device(rgba, dev)
    nt = x[..., 3].reshape(-1) > 0
    if int(nt.sum()) == 0:
        return rgba, custom_palette
    rgb = x[..., :3].reshape(-1, 3)
    palette = torch.from_numpy(np.ascontiguousarray(custom_palette)).to(dev)
    if distance_metric == "lab":
        pts, pal = C.rgb_u8_to_lab(rgb), C.rgb_u8_to_lab(palette)
    elif distance_metric == "hsv":
        pts, pal = C.rgb_u8_to_hsv_cv(rgb), C.rgb_u8_to_hsv_cv(palette)
    else:
        pts, pal = rgb.to(torch.float32), palette.to(torch.float32)
    out = P.map_nearest(pts, pal, palette, nt, rgba.shape[:2]).cpu().numpy()
    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    return np.dstack([out, alpha]), custom_palette


def get_color_statistics(rgba: np.ndarray, device="cuda") -> dict:
    """Statistics dict with the exact reference keys (color_simplify.py:345-384)."""
    _validate_rgba(rgba)
    dev = resolve_device(device)
    flat = _to_device(rgba, dev).reshape(-1, 4)
    packed = U.pack_rgba_u32(flat)
    n_unique = U.count_unique(packed, torch.ones_like(packed, dtype=torch.bool))
    nt = flat[:, 3] > 0
    n_nt = int(nt.sum())
    if n_nt > 0:
        # float32 results, as the JAX package's, from sums taken in
        # float64 (exact for the u8 colours, order-free for the squares)
        rgbf = flat[:, :3].to(torch.float64)
        w = nt.to(torch.float64)[:, None]
        cnt = torch.full((), n_nt, dtype=torch.float32, device=dev)
        mean = (rgbf * w).sum(dim=0).to(torch.float32) / cnt
        dev2 = (flat[:, :3].to(torch.float32) - mean) ** 2
        var = (dev2.to(torch.float64) * w).sum(dim=0).to(torch.float32) / cnt
        rgb_mean = mean.cpu().numpy()
        rgb_std = torch.sqrt(var).cpu().numpy()
    else:
        rgb_mean, rgb_std = np.array([0, 0, 0]), np.array([0, 0, 0])
    return {
        "total_unique_colors": int(n_unique),
        "non_transparent_pixels": n_nt,
        "rgb_mean": rgb_mean,
        "rgb_std": rgb_std,
        "image_size": rgba.shape[:2],
    }


def create_palette_from_colors(colors: List[Tuple[int, int, int]]) -> np.ndarray:
    """(reference color_simplify.py:1126-1141)"""
    return np.array(colors, dtype=np.uint8)


def check_gpu_availability() -> dict:
    """Accelerator probe with the reference's keys (color_simplify.py:
    1144-1187) and the JAX package's two TPU fields, which this package
    always reports as absent: its accelerator is the CUDA card."""
    info = {
        "cupy_available": False,
        "pytorch_available": True,
        "cuda_available": False,
        "gpu_count": 0,
        "gpu_names": [],
        "tpu_available": False,
        "tpu_count": 0,
    }
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        info["cuda_available"] = True
        info["gpu_count"] = n
        info["gpu_names"] = [torch.cuda.get_device_name(i) for i in range(n)]
    return info


def get_recommended_algorithm(image_size: tuple, gpu_available: bool = False) -> str:
    """Size-based auto-selection (reference color_simplify.py:1190-1219)."""
    h, w = image_size
    total_pixels = h * w
    if total_pixels > 1000000:
        return "perceptual" if gpu_available else "perceptual_fast"
    elif total_pixels > 500000:
        return "perceptual_fast"
    elif total_pixels > 100000:
        return "hsv_clustering"
    else:
        return "kmeans"


def simplify_colors_adaptive(
    rgba: np.ndarray,
    target_colors: int = 8,
    preserve_alpha: bool = True,
    algorithm: str = "kmeans",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatcher (reference color_simplify.py:280-342)."""
    args = (rgba, target_colors, preserve_alpha)
    if algorithm == "kmeans":
        return simplify_colors_kmeans(*args, device=device)
    elif algorithm == "median_cut":
        return simplify_colors_median_cut(*args, device=device)
    elif algorithm == "octree":
        return simplify_colors_octree(*args, device=device)
    elif algorithm == "threshold":
        return simplify_colors_threshold(*args, device=device)
    elif algorithm == "perceptual":
        return simplify_colors_perceptual(*args, device=device)
    elif algorithm == "perceptual_fast":
        return simplify_colors_perceptual_fast(*args, device=device)
    elif algorithm == "adaptive_distance":
        return simplify_colors_adaptive_distance(*args, device=device)
    elif algorithm == "hsv_clustering":
        return simplify_colors_hsv_clustering(*args, device=device)
    elif algorithm == "custom_palette":
        raise ValueError("Custom palette requires palette parameter")
    elif algorithm == "adaptive":
        stats = get_color_statistics(rgba, device=device)
        total_colors = stats["total_unique_colors"]
        if total_colors <= target_colors:
            return simplify_colors_threshold(*args, device=device)
        elif total_colors > 1000:
            return simplify_colors_perceptual(*args, device=device)
        else:
            return simplify_colors_hsv_clustering(*args, device=device)
    else:
        return simplify_colors_kmeans(*args, device=device)


# The four quantizers that live in _quantize_extra and _perceptual,
# re-exported under this module's names as in the JAX package.
def simplify_colors_median_cut(rgba, num_colors=8, preserve_alpha=True,
                               device="cuda"):
    return QX.simplify_colors_median_cut(rgba, num_colors, preserve_alpha,
                                         device=device)


def simplify_colors_octree(rgba, num_colors=8, preserve_alpha=True,
                           device="cuda"):
    return QX.simplify_colors_octree(rgba, num_colors, preserve_alpha,
                                     device=device)


def simplify_colors_perceptual(rgba, num_colors=8, preserve_alpha=True,
                               color_tolerance=30.0, use_gpu=False,
                               max_samples=10000, device="cuda"):
    return P.simplify_colors_perceptual(rgba, num_colors, preserve_alpha,
                                        color_tolerance, use_gpu, max_samples,
                                        device=device)


def simplify_colors_adaptive_distance(rgba, num_colors=8, preserve_alpha=True,
                                      similarity_threshold=25.0,
                                      device="cuda"):
    return P.simplify_colors_adaptive_distance(rgba, num_colors, preserve_alpha,
                                               similarity_threshold,
                                               device=device)
