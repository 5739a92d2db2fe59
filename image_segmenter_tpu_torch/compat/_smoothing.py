"""The five boundary smoothers (reference region_cleanup.py:788-1040).

Counterpart of image_segmenter_tpu/compat/_smoothing.py; numpy in, numpy
out, the work on `device`.

- morphological and multiscale: the reference overwrites the image colour
  by colour, so a pixel ends with the last colour whose smoothed mask
  covers it: the largest index, whatever order the masks are made in. The
  colours run as a leading batch axis of the binary shift reduction
  (ops/morphology._shift_reduce) in chunks of `CHUNK`, with the bits of
  the JAX package's sequential loop.
- gaussian: each colour's blend feeds the next, so it stays sequential.
  The blurs sum their taps in the JAX loop's order and round with
  floor(x + 0.5); the Gaussian taps are made on the host in float32
  numpy, so the card and the CPU use the same taps.
- bilateral: the colour weight depends on the integer L1 distance, so the
  weights come from a per-offset table built on the host in float32 numpy
  (as cv2 tabulates its colour weights), the same on every device; the
  sums go in the JAX loop's order. The palette snap is the port's blocked
  nearest-neighbour search (solvers/knn.nearest_index).
- contour: host geometry through ops/contours and the native engine.

`exp` rounds differently in XLA and in numpy, so gaussian and bilateral
may differ from the JAX package by one step of a channel.
"""

from __future__ import annotations

import numpy as np
import torch

from image_segmenter_tpu_torch.ops import color as C
from image_segmenter_tpu_torch.ops import contours as CONT
from image_segmenter_tpu_torch.ops import morphology as M
from image_segmenter_tpu_torch.ops import unique as U
from image_segmenter_tpu_torch.solvers import knn as NN
from image_segmenter_tpu_torch.utils.backend import resolve_device, true_div

_CAP = 4096  # max distinct colors a smoother loops over (reference: palette-sized)
CHUNK = 8  # colour masks smoothed together as one batch


def _validate_rgba(rgba: np.ndarray) -> None:
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError("rgba must be HxWx4 uint8")


def color_table(x: torch.Tensor):
    """(vals, n): the sorted unique opaque colours of an (H, W, 4) tensor as
    packed keys (the first n of `_CAP`), n read to the host."""
    nt = x[..., 3] > 0
    packed = C.pack_rgb_u32(x[..., :3]).reshape(-1)
    vals, _, n = U.packed_unique(packed, nt.reshape(-1), cap=_CAP)
    return vals, min(int(n), _CAP)


def open_close(masks: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """cv2 MORPH_OPEN then MORPH_CLOSE of a (B, H, W) bool batch."""
    m = M.erode_binary(masks, se)
    m = M.dilate_binary(m, se)
    m = M.dilate_binary(m, se)
    return M.erode_binary(m, se)


def last_cover(cid: torch.Tensor, nt: torch.Tensor, keys: torch.Tensor,
               entries, smooth) -> torch.Tensor:
    """(H, W) int64: the largest entry e whose smooth(mask of keys[e])
    covers the pixel, -1 where none does: the result of writing the entries
    one after another in order, last write wins.

    entries: ascending entry indices; smooth: (B, H, W) bool -> (B, H, W)
    bool. Runs the entries in chunks of `CHUNK` as one batch.
    """
    h, w = cid.shape
    best = torch.full((h, w), -1, dtype=torch.int64, device=cid.device)
    for s in range(0, len(entries), CHUNK):
        idx = torch.as_tensor(entries[s:s + CHUNK], device=cid.device)
        masks = nt[None] & (cid[None] == keys[idx][:, None, None])
        covered = smooth(masks)
        cand = torch.where(covered, idx[:, None, None], -1).amax(0)
        best = torch.maximum(best, cand)
    return best


def recolor(x: torch.Tensor, best: torch.Tensor, keys: torch.Tensor,
             keep_uncovered: bool) -> torch.Tensor:
    covered = best >= 0
    new_rgb = C.unpack_rgb_u32(keys[torch.clamp(best, 0, keys.shape[0] - 1)])
    if keep_uncovered:
        rgb = torch.where(covered[..., None], new_rgb, x[..., :3])
        alpha = torch.where(covered, 255, x[..., 3]).to(torch.uint8)
    else:
        rgb = torch.where(covered[..., None], new_rgb, 0).to(torch.uint8)
        alpha = torch.where(covered, 255, 0).to(torch.uint8)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


# --------------------------------------------------------------------------
# morphological (:788-827)
# --------------------------------------------------------------------------

def morphological_smoothing(rgba: np.ndarray, strength: float,
                            preserve_colors: bool, device="cuda") -> np.ndarray:
    _validate_rgba(rgba)
    if not np.any(rgba[..., 3] > 0):
        return rgba.copy()
    ksize = max(1, int(strength * 4) + 1)
    se = M.structuring_element(M.ELLIPSE, (ksize, ksize))
    x = torch.as_tensor(rgba, device=resolve_device(device))
    vals, n = color_table(x)
    cid = C.pack_rgb_u32(x[..., :3])
    best = last_cover(cid, x[..., 3] > 0, vals, list(range(n)),
                      lambda m: open_close(m, se))
    return recolor(x, best, vals, keep_uncovered=True).cpu().numpy()


# --------------------------------------------------------------------------
# gaussian (:914-977)
# --------------------------------------------------------------------------

def _gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """The JAX core's float32 Gaussian: exp(-(x*x) / (2 max(sigma, 1e-6)^2))
    normalised by its sum, taken in float32 numpy."""
    r = (ksize - 1) // 2
    xs = np.arange(ksize, dtype=np.float32) - np.float32(r)
    s = np.maximum(np.float32(sigma), np.float32(1e-6))
    g = np.exp(-(xs * xs) / (np.float32(2.0) * (s * s)))
    return g / g.sum(dtype=np.float32)


def _gaussian_core(x: torch.Tensor, vals: torch.Tensor, n: int,
                   sigma: float, ksize: int) -> torch.Tensor:
    h, w = x.shape[:2]
    nt = x[..., 3] > 0
    cid = C.pack_rgb_u32(x[..., :3])
    se3 = M.structuring_element(M.ELLIPSE, (3, 3))
    taps = torch.as_tensor(_gaussian_taps(ksize, sigma),
                           device=x.device).unbind(0)
    cols = C.unpack_rgb_u32(vals[:n]).to(torch.float32)

    def blur_u8(img_f):
        # separable blur with reflect-101 border, rounded like cv2 on uint8
        b = M.blur_taps(M.blur_taps(img_f, taps, 0), taps, 1)
        return torch.floor(b + 0.5)

    smoothed = x[..., :3]
    for k in range(n):
        mask = nt & (cid == vals[k])
        mf = mask.to(torch.float32)
        # close 3x3 (:947)
        closed = M.erode_binary(M.dilate_binary(mask[None], se3), se3)[0]
        blurred_mask = blur_u8(closed.to(torch.float32) * 255.0)  # u8-rounded
        m = true_div(blurred_mask, 255.0)
        strong = m > 0.3
        temp = mf[..., None] * cols[k]  # colour where mask else 0 (:953-954)
        blurred_temp = blur_u8(temp)  # u8-rounded per channel
        mm = m[..., None]
        blended = smoothed.to(torch.float32) * (1.0 - mm) + blurred_temp * mm
        # reference casts with .astype(np.uint8) -> truncation (:966-969)
        blended = torch.clamp(torch.floor(blended), 0, 255).to(torch.uint8)
        smoothed = torch.where(strong[..., None], blended, smoothed)
    return torch.cat([smoothed, x[..., 3:]], dim=-1)


def gaussian_smoothing(rgba: np.ndarray, strength: float,
                       preserve_colors: bool, device="cuda") -> np.ndarray:
    _validate_rgba(rgba)
    if not np.any(rgba[..., 3] > 0):
        return rgba.copy()
    ksize = max(3, int(strength * 6) + 1)
    if ksize % 2 == 0:
        ksize += 1
    sigma = strength * 1.0
    x = torch.as_tensor(rgba, device=resolve_device(device))
    if preserve_colors:
        vals, n = color_table(x)
        return _gaussian_core(x, vals, n, sigma, ksize).cpu().numpy()
    blurred = M.gaussian_blur(x[..., :3], ksize, sigma)
    out = rgba.copy()
    out[..., :3] = torch.clamp(torch.floor(blurred + 0.5), 0, 255) \
        .to(torch.uint8).cpu().numpy()
    return out


# --------------------------------------------------------------------------
# bilateral (:830-863)
# --------------------------------------------------------------------------

def _bilateral_weights(r: int, sigma_color: float, sigma_space: float):
    """The circular neighbourhood's offsets and, for each, the weight of
    every L1 colour distance 0..765: exp(gc * c * c + gs * (dx^2 + dy^2))
    in float32 as the JAX core forms it."""
    gc = np.float32(-0.5) / (np.float32(sigma_color) * np.float32(sigma_color))
    gs = np.float32(-0.5) / (np.float32(sigma_space) * np.float32(sigma_space))
    c = np.arange(3 * 255 + 1, dtype=np.float32)
    offsets, tables = [], []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy > r * r:
                continue  # cv2 uses a circular neighborhood
            arg = gc * c * c + gs * np.float32(dx * dx + dy * dy)
            offsets.append((dy, dx))
            tables.append(np.exp(arg.astype(np.float32)))
    return offsets, np.stack(tables)


def _bilateral_core(rgb: torch.Tensor, sigma_color: float,
                    sigma_space: float, d: int) -> torch.Tensor:
    """cv2.bilateralFilter semantics: L1 color distance across channels,
    Gaussian space/color weights, reflect-101 border."""
    h, w = rgb.shape[:2]
    r = d // 2 if d > 0 else 1
    offsets, tables = _bilateral_weights(r, sigma_color, sigma_space)
    tables = torch.as_tensor(tables, device=rgb.device)
    x = rgb.to(torch.float32)
    xi = rgb.to(torch.int32)
    xp = M.reflect_pad(M.reflect_pad(xi, r, 0), r, 1)
    num = torch.zeros_like(x)
    den = torch.zeros((h, w), dtype=torch.float32, device=rgb.device)
    for t, (dy, dx) in enumerate(offsets):
        nb = xp[r + dy:r + dy + h, r + dx:r + dx + w]
        cdist = torch.abs(nb - xi).sum(-1)
        wgt = tables[t][cdist]
        num = num + nb.to(torch.float32) * wgt[..., None]
        den = den + wgt
    out = num / torch.clamp_min(den, 1e-20)[..., None]
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)


def _palette_snap(filtered: torch.Tensor, x: torch.Tensor,
                  vals: torch.Tensor, n: int) -> torch.Tensor:
    """Snap non-transparent filtered pixels to the nearest original color.

    Replaces the reference's per-pixel python loop (:853-860), with the
    signed distance (the reference's uint8 difference wraps around; the
    JAX package fixes that too). Only the n real palette entries are
    searched: the padding is never nearest, so the indices are the same.
    """
    h, w = x.shape[:2]
    nt = x[..., 3] > 0
    uniq = C.unpack_rgb_u32(vals[:n]).to(torch.float32)
    valid = torch.ones(n, dtype=torch.bool, device=x.device)
    idx = NN.nearest_index(filtered.reshape(-1, 3).to(torch.float32), uniq, valid)
    snapped = C.unpack_rgb_u32(vals[idx]).reshape(h, w, 3)
    return torch.where(nt[..., None], snapped, filtered)


def bilateral_smoothing(rgba: np.ndarray, strength: float,
                        preserve_colors: bool, device="cuda") -> np.ndarray:
    _validate_rgba(rgba)
    if not np.any(rgba[..., 3] > 0):
        return rgba.copy()
    d = max(1, int(strength * 9) + 1)
    sigma_color = max(1, int(strength * 75) + 1)
    sigma_space = max(1, int(strength * 75) + 1)
    x = torch.as_tensor(rgba, device=resolve_device(device))
    filtered = _bilateral_core(x[..., :3], sigma_color, sigma_space, d)
    if preserve_colors:
        vals, n = color_table(x)
        filtered = _palette_snap(filtered, x, vals, n)
    out = rgba.copy()
    out[..., :3] = filtered.cpu().numpy()
    return out


# --------------------------------------------------------------------------
# contour (:866-911): host geometry
# --------------------------------------------------------------------------

def contour_smoothing(rgba: np.ndarray, strength: float,
                      preserve_colors: bool) -> np.ndarray:
    _validate_rgba(rgba)
    if not np.any(rgba[..., 3] > 0):
        return rgba.copy()
    h, w = rgba.shape[:2]
    nt = rgba[..., 3] > 0
    # packed keys sort as the reference's np.unique(axis=0) rows do
    rgb = rgba[..., :3].astype(np.int32)
    key = np.where(nt, (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2], -1)
    smoothed = np.zeros_like(rgba)
    for k in np.unique(key[nt]):
        color = np.array([k >> 16, (k >> 8) & 255, k & 255], np.uint8)
        mask = key == k
        conts = CONT.external_contours(mask)
        if not conts:
            continue
        # reference scales epsilon by the FIRST contour's arc length (:897)
        eps = strength * 0.02 * CONT.arc_length(conts[0], closed=True)
        fill = np.zeros((h, w), np.uint8)
        for cont in conts:
            approx = CONT.approx_poly_dp(cont, eps, closed=True)
            CONT.fill_polygon(fill, approx)
        smoothed[fill > 0, :3] = color
        smoothed[fill > 0, 3] = 255
    return smoothed


# --------------------------------------------------------------------------
# multiscale (:980-1040)
# --------------------------------------------------------------------------

def multiscale_smoothing(rgba: np.ndarray, strength: float,
                         preserve_colors: bool, device="cuda") -> np.ndarray:
    _validate_rgba(rgba)
    if not np.any(rgba[..., 3] > 0):
        return rgba.copy()
    from image_segmenter_tpu_torch.compat.region_cleanup import analyze_regions

    stats = analyze_regions(rgba, min_size_threshold=10, device=device)
    all_regions = stats.get("all_regions", [])
    if not all_regions:
        return rgba.copy()

    sizes = [r["size"] for r in all_regions]
    max_size, min_size = max(sizes), min(sizes)
    large_thr = min_size + (max_size - min_size) * 0.7
    medium_thr = min_size + (max_size - min_size) * 0.3

    # Region write order == analyze order; kernel size per region from its
    # size tier (:1010-1035). Same (color, kernel) writes share a footprint;
    # the LAST write with a given footprint sets its priority.
    entries = {}  # (packed_color, ksize or -1) -> priority (write order)
    for order, region in enumerate(all_regions):
        rs = region["size"]
        tier = (0.3 if rs >= large_thr else 0.6 if rs >= medium_thr else 1.0)
        region_strength = strength * tier
        ks = max(1, int(region_strength * 5) + 1) if region_strength > 0.1 else -1
        c = region["color"]
        packed = (c[0] << 16) | (c[1] << 8) | c[2]
        entries[(packed, ks)] = order

    ordered = sorted(entries.items(), key=lambda kv: kv[1])
    x = torch.as_tensor(rgba, device=resolve_device(device))
    keys = torch.as_tensor([packed for (packed, _), _ in ordered],
                           dtype=torch.int64, device=x.device)
    cid = C.pack_rgb_u32(x[..., :3])
    nt = x[..., 3] > 0
    # each footprint's entries smoothed as batches; the winner per pixel is
    # the largest entry index over all footprints
    best = None
    for ks in sorted({ks for (_, ks), _ in ordered}):
        group = [e for e, ((_, k), _) in enumerate(ordered) if k == ks]
        if ks > 0:
            se = M.structuring_element(M.ELLIPSE, (ks, ks))
            smooth = lambda m, se=se: open_close(m, se)  # noqa: E731
        else:
            smooth = lambda m: m  # noqa: E731
        b = last_cover(cid, nt, keys, group, smooth)
        best = b if best is None else torch.maximum(best, b)
    return recolor(x, best, keys, keep_uncovered=False).cpu().numpy()
