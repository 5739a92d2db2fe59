"""Region analysis / merging / flood fill / boundaries, reference-compatible.

Counterpart of image_segmenter_tpu/compat/region_cleanup.py (reference
app/processing/region_cleanup.py): numpy in, numpy out, the work on
`device`, the card unless the caller asks for the CPU.

- analyze_regions (reference :9-130): one labelling over all colours at
  once (pixels connect iff equal colour) and segment reductions in place of
  the per-colour cv2.connectedComponentsWithStats loop.
- merge_small_regions (:314-512): each pass labels the image and scores
  every (small component, adjacent colour) pair with the reference's hybrid
  score on the device, picks each component's target with the reference's
  tie-breaks and recolours, under the same <= merge_max_passes and
  no-progress stopping rules. As in the JAX package, all merges of a pass
  are computed from the pass-start image and applied together.
- flood_fill_region (:515-574): exact-colour flood fill == recolouring the
  seed's 4-connected component.
- get_region_boundaries (:665-746): morphological gradient -> threshold,
  with the reference's fallback ladder.
- smooth_region_boundaries (:749-1040): see compat/_smoothing.py.

The components are labelled on the entry's device
(ops/connected_components), in analyze_regions, in every merge pass and in
the flood fill. Where the JAX package labels on the host when the native
union-find builds, the port's choice follows `device` alone: the image
stays on the card for all of a merge's passes. The native union-find
(ops/native.label_components_host) is the tests' oracle.

Stats dicts keep the exact reference keys; the progress-callback protocol
(current, total, message) is preserved.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.ops import color as C
from image_segmenter_tpu_torch.ops import connected_components as CCOMP
from image_segmenter_tpu_torch.ops import edges as EDG
from image_segmenter_tpu_torch.ops import morphology as M
from image_segmenter_tpu_torch.ops import unique as U
from image_segmenter_tpu_torch.utils.backend import resolve_device, true_div

_COLOR_CAP = 1 << 16
_MAX_LAB_DISTANCE = 255.0 * np.sqrt(3.0)
_NEIGHBORS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_NEIGHBORS_8 = _NEIGHBORS_4 + ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _validate_rgba(rgba: np.ndarray) -> None:
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError("rgba must be HxWx4 uint8")


def _empty_stats() -> Dict:
    return {
        "total_regions": 0,
        "small_regions": 0,
        "largest_region_size": 0,
        "smallest_region_size": 0,
        "size_distribution": {},
        "region_colors": [],
        "region_sizes": [],
        "all_regions": [],
    }


def _to_device(rgba: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(rgba), device=dev)


def _stats_on(x: torch.Tensor, connectivity: int):
    """(labels, sizes, bbox) of an (H, W, 4) uint8 tensor, on its device."""
    return CCOMP.component_stats(C.pack_rgb_u32(x[..., :3]), x[..., 3] > 0,
                                 connectivity)


# --------------------------------------------------------------------------
# analyze_regions
# --------------------------------------------------------------------------

def analyze_regions(rgba: np.ndarray, min_size_threshold: int = 100,
                    connectivity: int = 8, device="cuda") -> Dict:
    """Per-color connected-component statistics (reference :9-130)."""
    _validate_rgba(rgba)
    h, w = rgba.shape[:2]
    if not (rgba[..., 3] > 0).any():
        return _empty_stats()
    dev = resolve_device(device)
    labels, sizes_all, bbox_all = (
        a.cpu().numpy() for a in _stats_on(_to_device(rgba, dev), connectivity))
    roots = np.unique(labels[labels >= 0])
    # a component's colour is the colour at its root pixel
    root_colors = rgba[..., :3].reshape(-1, 3)[roots]
    packed = (
        root_colors[:, 0].astype(np.uint32) * 65536
        + root_colors[:, 1].astype(np.uint32) * 256
        + root_colors[:, 2].astype(np.uint32)
    )
    # Reference enumerates colors in np.unique (ascending) order, components
    # within a color in cv2 label order == raster order of first pixel ==
    # ascending root index.
    order = np.lexsort((roots, packed))
    roots = roots[order]
    packed = packed[order]
    root_colors = root_colors[order]

    # Per-color shared arrays (reference stores cv2's per-color label image
    # and mask in each region dict; arrays are shared across same-color
    # regions). A pixel's component gives both: its colour (the colour
    # group of its root) and its label in that colour's image (the root's
    # rank within the group, from 1), so one gather per pixel replaces the
    # JAX module's per-colour search.
    all_regions: List[Dict] = []
    region_colors: List[Tuple] = []
    region_sizes: List[int] = []
    small = 0

    new_color = np.concatenate([[True], packed[1:] != packed[:-1]])
    color_starts = np.flatnonzero(new_color)
    color_ends = np.concatenate([color_starts[1:], [len(packed)]])
    group = np.cumsum(new_color) - 1
    rank_of_root = np.zeros(h * w, np.int32)
    rank_of_root[roots] = np.arange(len(roots)) - color_starts[group] + 1
    group_of_root = np.full(h * w, -1, np.int32)
    group_of_root[roots] = group
    flat_lbl = labels.reshape(-1)
    on = flat_lbl >= 0
    safe = np.where(on, flat_lbl, 0)
    pix_group = np.where(on, group_of_root[safe], -1).reshape(h, w)
    pix_rank = np.where(on, rank_of_root[safe], 0).reshape(h, w)
    for gi, (cs, ce) in enumerate(zip(color_starts, color_ends)):
        color = tuple(int(v) for v in root_colors[cs])
        c_roots = roots[cs:ce]
        in_color = pix_group == gi
        color_mask_u8 = in_color.astype(np.uint8) * 255
        lbl_img = np.where(in_color, pix_rank, 0).astype(np.int32)
        areas = sizes_all[c_roots].tolist()
        boxes = bbox_all[c_roots].tolist()
        for i, (area, (x0, y0, x1, y1)) in enumerate(zip(areas, boxes), start=1):
            if area <= 0:
                continue
            info = {
                "color": color,
                "size": area,
                "label": i,
                "color_mask": color_mask_u8,
                "labels": lbl_img,
                "component_id": i,
                "bbox": (x0, y0, x1 - x0 + 1, y1 - y0 + 1),
            }
            all_regions.append(info)
            region_colors.append(color)
            region_sizes.append(area)
            if area < min_size_threshold:
                small += 1

    if not region_sizes:
        return _empty_stats()

    size_distribution: Dict[str, int] = {}
    for s in region_sizes:
        key = ("< 50" if s < 50 else "50-99" if s < 100 else "100-199" if s < 200
               else "200-499" if s < 500 else "500+")
        size_distribution[key] = size_distribution.get(key, 0) + 1

    return {
        "total_regions": len(region_sizes),
        "small_regions": small,
        "largest_region_size": max(region_sizes),
        "smallest_region_size": min(region_sizes),
        "size_distribution": size_distribution,
        "region_colors": region_colors,
        "region_sizes": region_sizes,
        "all_regions": all_regions,
    }


# --------------------------------------------------------------------------
# neighbor finding (public API, reference :133-217)
# --------------------------------------------------------------------------

def _neighbor_kernel(connectivity: int) -> np.ndarray:
    if connectivity == 4:
        return np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=np.uint8)
    return np.ones((3, 3), np.uint8)


def find_neighboring_colors_for_component(
    rgba: np.ndarray, component_mask: np.ndarray, connectivity: int = 8,
    device="cuda",
) -> List[Tuple[int, int, int]]:
    """(reference :133-173)"""
    dev = resolve_device(device)
    x = _to_device(rgba, dev)
    mask = torch.as_tensor(np.asarray(component_mask).astype(bool), device=dev)
    dil = M.dilate_binary(mask[None], _neighbor_kernel(connectivity))[0]
    adjacent = dil & ~mask & (x[..., 3] > 0)
    packed = C.pack_rgb_u32(x[..., :3]).reshape(-1)
    vals, _, n = U.packed_unique(packed, adjacent.reshape(-1), cap=4096)
    cols = C.unpack_rgb_u32(vals[:int(n)]).cpu().numpy()
    return [tuple(int(v) for v in c) for c in cols]


def find_neighboring_colors(
    rgba: np.ndarray, target_color: Tuple[int, int, int], connectivity: int = 8,
    device="cuda",
) -> List[Tuple[int, int, int]]:
    """(reference :176-217)"""
    rgb = rgba[:, :, :3]
    alpha = rgba[:, :, 3]
    target_mask = np.all(rgb == target_color, axis=2) & (alpha > 0)
    return find_neighboring_colors_for_component(rgba, target_mask,
                                                 connectivity, device=device)


# --------------------------------------------------------------------------
# merge scoring (public API, reference :220-311)
# --------------------------------------------------------------------------

def _lab_cv_rounded(rgb_u8: torch.Tensor) -> torch.Tensor:
    """cv2 8-bit LAB with rounding to integers, as color_distance sees it."""
    return torch.round(C.rgb_u8_to_lab_cv(rgb_u8))


def color_distance(color1: Tuple[int, int, int], color2: Tuple[int, int, int],
                   device="cuda") -> float:
    """Normalized LAB distance (reference :281-311; cv2 8-bit LAB semantics)."""
    pair = torch.as_tensor(np.array([color1, color2], dtype=np.uint8),
                           device=resolve_device(device))
    lab = _lab_cv_rounded(pair).cpu().numpy().astype(np.float64)
    d = float(np.linalg.norm(lab[0] - lab[1]) / _MAX_LAB_DISTANCE)
    return min(1.0, max(0.0, d))


def calculate_merge_score(
    small_region: dict,
    neighbor_color: Tuple[int, int, int],
    neighbor_region_size: int,
    image_context: dict,
    weights: dict = None,
    device="cuda",
) -> float:
    """Hybrid merge score (reference :220-278)."""
    if weights is None:
        weights = {"color": 0.4, "spatial": 0.3, "frequency": 0.2, "size": 0.1}
    color_sim = 1.0 - color_distance(small_region["color"], neighbor_color,
                                     device=device)
    spatial_prox = 0.5  # reference placeholder (:261)
    total_pixels = image_context.get("total_pixels", 1)
    neighbor_pixel_count = image_context.get("color_counts", {}).get(neighbor_color, 1)
    frequency = min(1.0, neighbor_pixel_count / (total_pixels * 0.1))
    max_region_size = image_context.get("max_region_size", 1)
    size_factor = min(1.0, neighbor_region_size / max_region_size)
    return (weights["color"] * color_sim + weights["spatial"] * spatial_prox
            + weights["frequency"] * frequency + weights["size"] * size_factor)


# --------------------------------------------------------------------------
# merge_small_regions: one pass on the device
# --------------------------------------------------------------------------

def _scatter(n: int, init, index, src, how):
    out = torch.full((n,), init, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, index, src, how)


def _merge_pass(rgba: torch.Tensor, labels: torch.Tensor, sizes: torch.Tensor,
                min_size, auto_thr, wts: torch.Tensor, connectivity: int):
    """One merge pass. Returns (new_rgba, n_small_before, n_auto_merged),
    the counts as 0-d tensors.

    Scores every adjacency event (a small component's pixel next to an
    opaque pixel of another colour) with the reference's hybrid score,
    reduces over each pixel's own events and then, with one integer or max
    scatter per statistic, over the component. float32 throughout, in the
    JAX pass's order of operations.
    """
    h, w = rgba.shape[:2]
    hw = h * w
    dev = rgba.device
    valid = rgba[..., 3] > 0
    rgb = rgba[..., :3]
    cid2d = C.pack_rgb_u32(rgb)
    flat_lbl = labels.reshape(-1).to(torch.int64)
    on_comp = flat_lbl >= 0
    safe_lbl = torch.where(on_comp, flat_lbl, 0)

    comp_size_px = torch.where(on_comp, sizes[safe_lbl], 0).reshape(h, w)
    small_px = valid & (comp_size_px < min_size)
    is_small_root = (sizes > 0) & (sizes < min_size)
    n_small = is_small_root.sum()

    # Color table: counts per unique color, index per pixel.
    packed = cid2d.reshape(-1)
    vals, counts, _ = U.packed_unique(packed, valid.reshape(-1), cap=_COLOR_CAP)
    cidx = torch.clamp(torch.searchsorted(vals, packed), 0, _COLOR_CAP - 1)
    color_count_px = counts[cidx].reshape(h, w)

    total_pixels = valid.sum().to(torch.float32)
    freq_den = total_pixels * 0.1
    max_region_size = sizes.max().to(torch.float32)
    lab = _lab_cv_rounded(rgb)  # cv2-LAB as color_distance sees it
    one = torch.ones((), dtype=torch.float32, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=torch.float32, device=dev)
    spatial = wts[1] * 0.5

    px_best = torch.full((hw,), float("-inf"), dtype=torch.float32, device=dev)
    px_min_c = torch.full((hw,), _COLOR_CAP, dtype=torch.int64, device=dev)
    px_max_c = torch.full((hw,), -1, dtype=torch.int64, device=dev)
    events = []
    shifts = _NEIGHBORS_4 if connectivity == 4 else _NEIGHBORS_8
    cidx2d = cidx.reshape(h, w)
    for dy, dx in shifts:
        q_valid = M.shift2d(valid, dy, dx, False)
        q_cid = M.shift2d(cid2d, dy, dx, 0)
        q_lab = M.shift2d(lab, dy, dx, 0.0)
        q_cidx = M.shift2d(cidx2d, dy, dx, _COLOR_CAP)
        q_ccount = M.shift2d(color_count_px, dy, dx, 0.0)
        event = small_px & q_valid & (q_cid != cid2d)
        d = lab - q_lab
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        dist = true_div(torch.sqrt(d2), _MAX_LAB_DISTANCE)
        color_sim = 1.0 - torch.minimum(dist, one)
        frequency = torch.minimum(one, q_ccount / freq_den)
        size_factor = torch.minimum(one, q_ccount / max_region_size)
        score = ((wts[0] * color_sim + spatial) + wts[2] * frequency) \
            + wts[3] * size_factor
        score = torch.where(event, score, neg_inf).reshape(-1)
        qq = torch.where(event, q_cidx, _COLOR_CAP).reshape(-1)
        px_best = torch.maximum(px_best, score)
        px_min_c = torch.minimum(px_min_c, qq)
        px_max_c = torch.maximum(px_max_c, torch.where(qq < _COLOR_CAP, qq, -1))
        events.append((score, qq))

    best_score = _scatter(hw, float("-inf"), safe_lbl,
                          torch.where(on_comp, px_best, neg_inf), "amax")
    nb_min_color = _scatter(hw, _COLOR_CAP, safe_lbl,
                            torch.where(on_comp, px_min_c, _COLOR_CAP), "amin")
    nb_max_color = _scatter(hw, -1, safe_lbl,
                            torch.where(on_comp, px_max_c, -1), "amax")

    # Among events at the root's best score, the smallest colour index
    # (reference tie-break: stable sort + np.unique ascending order).
    root_best_px = best_score[safe_lbl]
    px_best_color = torch.full((hw,), _COLOR_CAP, dtype=torch.int64, device=dev)
    for score, qq in events:
        at_best = score >= root_best_px - 1e-7
        px_best_color = torch.minimum(
            px_best_color, torch.where(at_best, qq, _COLOR_CAP))
    best_color = _scatter(hw, _COLOR_CAP, safe_lbl,
                          torch.where(on_comp, px_best_color, _COLOR_CAP), "amin")

    single_neighbor = (nb_min_color == nb_max_color) & (nb_max_color >= 0)
    has_neighbor = nb_max_color >= 0
    # No-neighbor fallback: the most common colour (first max = smallest)
    most_common = torch.argmax(counts)

    root_small = is_small_root
    do_auto = root_small & has_neighbor & (single_neighbor | (best_score >= auto_thr))
    # merge_callback is None on this path: the rest merge into the best
    do_fallback_best = root_small & has_neighbor & ~do_auto
    chosen = torch.where(do_auto | do_fallback_best, best_color,
                         torch.where(root_small, most_common, _COLOR_CAP))
    chosen = torch.clamp(chosen, 0, _COLOR_CAP - 1)

    new_color_px = C.unpack_rgb_u32(vals[chosen[safe_lbl]]).reshape(h, w, 3)
    recolor = (small_px & on_comp.reshape(h, w))[..., None]
    new_rgb = torch.where(recolor, new_color_px, rgb)
    out = torch.cat([new_rgb, rgba[..., 3:]], dim=-1)
    return out, n_small, root_small.sum()


def merge_small_regions(
    rgba: np.ndarray,
    min_size: int,
    merge_callback: Optional[callable] = None,
    auto_merge_threshold: float = 0.7,
    merge_weights: dict = None,
    progress_callback: Optional[callable] = None,
    connectivity: int = 8,
    device="cuda",
) -> np.ndarray:
    """Multi-pass small-region merging (reference :314-512).

    Each pass labels and merges on the device; the host reads two counts a
    pass (small regions, merged) and the final image. With a
    merge_callback, regions below the auto-merge threshold are presented to
    the callback exactly like the reference (host path).
    """
    _validate_rgba(rgba)
    dev = resolve_device(device)
    if merge_weights is None:
        wts = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    else:
        wts = np.array([merge_weights.get("color", 0.4),
                        merge_weights.get("spatial", 0.3),
                        merge_weights.get("frequency", 0.2),
                        merge_weights.get("size", 0.1)], np.float32)

    if progress_callback:
        progress_callback(0, 100, "Analyzing regions...")
        progress_callback(10, 100, "Building image context...")

    result = _to_device(rgba, dev)
    wts_d = torch.as_tensor(wts, device=dev)
    auto_thr = torch.tensor(auto_merge_threshold, dtype=torch.float32, device=dev)
    max_passes = DEFAULTS.merge_max_passes
    total_auto = 0
    total_user = 0
    previous_small = float("inf")
    pass_num = 0

    while pass_num < max_passes:
        pass_num += 1
        if progress_callback:
            progress_callback(min(20 + (pass_num - 1) * 25, 95), 100,
                              f"Pass {pass_num}: Analyzing regions...")

        if merge_callback is not None:
            result_np, n_small, auto, user, cancelled = _merge_pass_interactive(
                result.cpu().numpy(), min_size, auto_merge_threshold, wts,
                connectivity, merge_callback, device=dev)
            if cancelled:
                return None
            result = _to_device(result_np, dev)
            n_merged = auto + user
            total_user += user
        else:
            labels, sizes, _ = _stats_on(result, connectivity)
            new_result, n_small_d, n_merged_d = _merge_pass(
                result, labels, sizes, int(min_size), auto_thr, wts_d,
                connectivity)
            n_small, auto = torch.stack([n_small_d, n_merged_d]).tolist()
            n_merged = auto
            if n_small > 0:
                result = new_result

        if n_small == 0:
            break
        if n_small >= previous_small:
            print(f"No progress made in pass {pass_num}, stopping early")
            break
        previous_small = n_small
        total_auto += auto
        if progress_callback:
            progress_callback(min(20 + pass_num * 25, 95), 100,
                              f"Pass {pass_num} complete: {auto} auto-merged, "
                              f"{n_merged - auto} user decisions")

    if progress_callback:
        progress_callback(100, 100,
                          f"Complete: {total_auto} auto-merged, {total_user} user "
                          f"decisions in {pass_num} passes")
    print(f"Region cleanup complete: {total_auto} auto-merged, "
          f"{total_user} user decisions in {pass_num} passes")
    # a copy: on the CPU the tensor may still share the caller's array
    return np.array(result.cpu().numpy())


def _merge_pass_interactive(rgba, min_size, auto_thr, wts, connectivity,
                            merge_callback, device="cuda"):
    """Host-sequential pass for the interactive merge_callback path
    (reference :424-497: each low-confidence region asks the user)."""
    stats = analyze_regions(rgba, min_size, connectivity, device=device)
    all_regions = stats.get("all_regions", [])
    image_context = {
        "total_pixels": int((rgba[..., 3] > 0).sum()),
        "max_region_size": max([r["size"] for r in all_regions], default=1),
        "color_counts": {},
    }
    for region in all_regions:
        c = region["color"]
        image_context["color_counts"][c] = image_context["color_counts"].get(c, 0) + region["size"]

    small_regions = [r for r in all_regions if r["size"] < min_size]
    result = rgba.copy()
    rgb = result[:, :, :3]
    alpha = result[:, :, 3]
    auto = user = 0
    for region in small_regions:
        component_mask = (region["labels"] == region["component_id"]) & (alpha > 0)
        if not component_mask.any():
            continue
        neighbor_colors = find_neighboring_colors_for_component(
            result, component_mask, connectivity, device=device)
        if not neighbor_colors:
            if image_context["color_counts"]:
                neighbor_colors = [max(image_context["color_counts"].items(), key=lambda x: x[1])[0]]
            else:
                continue
        scores = sorted(
            ((c, calculate_merge_score(region, c,
                                       int(np.sum(np.all(rgb == c, axis=2) & (alpha > 0))),
                                       image_context, device=device))
             for c in neighbor_colors),
            key=lambda x: x[1], reverse=True)
        best_color, best_score = scores[0]
        if len(neighbor_colors) == 1 or best_score >= auto_thr:
            rgb[component_mask] = best_color
            auto += 1
        else:
            # The reference hands QColor objects to the callback
            # (region_cleanup.py:476-489); tuples where Qt is not installed.
            bbox = get_component_bounding_box(component_mask, buffer=10)
            try:
                from PySide6.QtGui import QColor  # type: ignore

                target = QColor(*region["color"])
                neighbors = [QColor(*c) for c in neighbor_colors]
            except ImportError:
                target, neighbors = region["color"], neighbor_colors
            choice = merge_callback(target, neighbors, result, bbox)
            if choice is None:
                return result, len(small_regions), auto, user, True
            if hasattr(choice, "red"):
                choice = (choice.red(), choice.green(), choice.blue())
            rgb[component_mask] = choice
            user += 1
    return result, len(small_regions), auto, user, False


# --------------------------------------------------------------------------
# flood fill
# --------------------------------------------------------------------------

def flood_fill_region(rgba: np.ndarray, seed_point: Tuple[int, int],
                      fill_color: Tuple[int, int, int],
                      device="cuda") -> np.ndarray:
    """(reference :515-574). Exact-color 4-connected fill via CC labeling."""
    result = np.ascontiguousarray(rgba.copy(), dtype=np.uint8)
    x, y = seed_point
    h, w = result.shape[:2]
    if x < 0 or y < 0 or x >= w or y >= h:
        return result
    if result[y, x, 3] == 0:
        return result
    out = CCOMP.flood_fill_component(
        _to_device(result, resolve_device(device)), (y, x),
        np.asarray(fill_color, np.uint8))
    return out.cpu().numpy()


def _manual_flood_fill(rgba: np.ndarray, seed_point: Tuple[int, int],
                       fill_color: Tuple[int, int, int],
                       device="cuda") -> np.ndarray:
    """Kept for API parity with the reference's fallback (:577-626); the
    labelling path has no cv2 failure mode, so this simply delegates."""
    return flood_fill_region(rgba, seed_point, fill_color, device=device)


# --------------------------------------------------------------------------
# bounding boxes & boundaries
# --------------------------------------------------------------------------

def get_component_bounding_box(component_mask: np.ndarray, buffer: int = 10
                               ) -> Optional[Tuple[int, int, int, int]]:
    """(reference :629-662)"""
    if not np.any(component_mask):
        return None
    rows = np.any(component_mask, axis=1)
    cols = np.any(component_mask, axis=0)
    y_min, y_max = np.where(rows)[0][[0, -1]]
    x_min, x_max = np.where(cols)[0][[0, -1]]
    h, w = component_mask.shape
    x_min = max(0, x_min - buffer)
    y_min = max(0, y_min - buffer)
    x_max = min(w, x_max + buffer + 1)
    y_max = min(h, y_max + buffer + 1)
    return (int(x_min), int(y_min), int(x_max - x_min), int(y_max - y_min))


def _boundaries_core(x: torch.Tensor, connectivity: int) -> torch.Tensor:
    """The reference's ladder: the morphological gradient; else each
    region's outer boundary pixels; else cv2.Canny(gray, 5, 15). A rung is
    computed only when the one above it is empty (one host read each)."""
    h, w = x.shape[:2]
    mask = x[..., 3] > 0
    gray = C.rgb_u8_to_gray_cv(x[..., :3])
    se = M.structuring_element(M.ELLIPSE, (3, 3))
    boundaries = (M.morphological_gradient(gray, se) > 10) & mask
    if not bool(boundaries.any()):
        # Fallback 2 (reference :707-734): pixels whose component differs
        # from some 8-neighbour's.
        cid = C.pack_rgb_u32(x[..., :3])
        labels = CCOMP.label_components(
            cid, torch.ones((h, w), dtype=torch.bool, device=x.device),
            connectivity)
        edge = torch.zeros((h, w), dtype=torch.bool, device=x.device)
        for dy, dx in _NEIGHBORS_8:
            edge |= M.shift2d(labels, dy, dx, -2) != labels
        boundaries = edge & mask
    if not bool(boundaries.any()):
        # Fallback 3 (reference :737-739): cv2.Canny(gray, 5, 15), only
        # reachable on a boundary-free image.
        boundaries = (EDG.canny_core(gray, 5.0, 15.0) > 0) & mask
    out = torch.zeros((h, w, 4), dtype=torch.uint8, device=x.device)
    out[..., :3] = 255
    out[..., 3] = boundaries.to(torch.uint8) * 255
    return out


def get_region_boundaries(rgba: np.ndarray, connectivity: int = 8,
                          device="cuda") -> np.ndarray:
    """(reference :665-746) White boundaries on transparent background."""
    _validate_rgba(rgba)
    if not np.any(rgba[..., 3] > 0):
        return np.zeros((rgba.shape[0], rgba.shape[1], 4), dtype=np.uint8)
    x = _to_device(rgba, resolve_device(device))
    return _boundaries_core(x, connectivity).cpu().numpy()


# --------------------------------------------------------------------------
# smoothing (implementations in compat/_smoothing.py)
# --------------------------------------------------------------------------

def smooth_region_boundaries(rgba: np.ndarray, method: str = "morphological",
                             strength: float = 0.5,
                             preserve_colors: bool = True,
                             device="cuda") -> np.ndarray:
    """(reference :749-785)"""
    from image_segmenter_tpu_torch.compat import _smoothing as S

    if method == "morphological":
        return S.morphological_smoothing(rgba, strength, preserve_colors, device=device)
    elif method == "bilateral":
        return S.bilateral_smoothing(rgba, strength, preserve_colors, device=device)
    elif method == "contour":
        return S.contour_smoothing(rgba, strength, preserve_colors)
    elif method == "gaussian":
        return S.gaussian_smoothing(rgba, strength, preserve_colors, device=device)
    elif method == "multiscale":
        return S.multiscale_smoothing(rgba, strength, preserve_colors, device=device)
    else:
        raise ValueError(f"Unknown smoothing method: {method}")
