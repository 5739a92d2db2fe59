"""Perceptual (Ward/LAB) and adaptive-distance (DBSCAN) quantizers.

Counterpart of image_segmenter_tpu/compat/_perceptual.py:

- simplify_colors_perceptual (reference color_simplify.py:387-559):
  unique sampled colours -> exact Ward clustering in LAB
  (solvers.agglomerative) -> frequency-weighted RGB centres -> full-image
  LAB nearest-centre map. `use_gpu` is accepted and ignored, as in the JAX
  package (the reference's path behind it is vestigial).

- simplify_colors_adaptive_distance (reference color_simplify.py:710-882):
  standardised-LAB DBSCAN (solvers.dbscan over deduplicated colours with
  multiplicities) -> noise adoption -> k-means rescue (< k) or
  smallest-into-nearest merging (> k) -> pixel-weighted RGB centres ->
  black-pixel adoption.

bug_compat=True reproduces perceptual's map of LAB pixels against RGB
centres (color_simplify.py:544); by default the map compares LAB to LAB.

numpy in, numpy out; `device` is "cuda" by default and raises when the
card is absent.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from image_segmenter_tpu_torch.compat._quantize_extra import (
    _alpha_out_np, _map_via_unique, _to_device, _validate_rgba)
from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.ops import color as C
from image_segmenter_tpu_torch.ops import unique as U
from image_segmenter_tpu_torch.solvers import agglomerative as AG
from image_segmenter_tpu_torch.solvers import dbscan as DB
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.solvers import knn as NN
from image_segmenter_tpu_torch.utils import prng as PRNG
from image_segmenter_tpu_torch.utils.backend import resolve_device

# Stage attribution of the most recent adaptive_distance call (seconds per
# stage on the host clock, each stamp taken after a device-to-host copy).
LAST_SOLVE_INFO: dict = {}


def _fallback(rgba: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return rgba, np.array([[0, 0, 0]])


def _bucket(n: int, lo: int = 512, hi: int = 1 << 16) -> int:
    b = lo
    while b < min(n, hi):
        b <<= 1
    return b


def _f32(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)


def seeded_sample_mask(nt: torch.Tensor, sample_cap: int) -> torch.Tensor:
    """A seeded sample of at most `sample_cap` of the pixels in `nt`: a
    uniform priority per pixel from key(kmeans_seed), keep the lowest
    (the reference samples with an unseeded np.random)."""
    n = nt.shape[0]
    pri = PRNG.uniform(PRNG.key(DEFAULTS.kmeans_seed), (n,), nt.device)
    pri = torch.where(nt, pri, 2.0)
    kth = torch.sort(pri).values[min(sample_cap, n) - 1]
    return nt & (pri <= kth)


def _unique_nt(rgba: torch.Tensor, cap: int, sample_cap: int | None):
    """Unique colours (+ counts) of the non-transparent pixels, or of a
    seeded sample of at most `sample_cap` of them."""
    flat = rgba[..., :3].reshape(-1, 3)
    nt = rgba[..., 3].reshape(-1) > 0
    chosen = nt if sample_cap is None else seeded_sample_mask(nt, sample_cap)
    vals, counts, n_unique = U.packed_unique(C.pack_rgb_u32(flat), chosen,
                                             cap=cap)
    return vals, counts, n_unique, nt.sum()


def map_nearest(points: torch.Tensor, centers: torch.Tensor,
                colors_u8: torch.Tensor, keep: torch.Tensor, hw) -> torch.Tensor:
    """colors_u8[nearest centre] for the pixels in `keep`, black for the
    rest: points (N, 3), centers (k, 3) in the same space -> (h, w, 3) u8.
    Plain PyTorch through `assign_labels`, as the JAX package computes
    these maps outside any Pallas kernel."""
    labels = KM.assign_labels(points[None], centers.to(torch.float32)[None])[0]
    mapped = colors_u8[labels]
    out = torch.where(keep[:, None], mapped, torch.zeros_like(mapped))
    return out.reshape(*hw, 3)


def _map_lab_centers(rgba: torch.Tensor, centers_rgb_u8: torch.Tensor,
                     bug_compat: bool) -> torch.Tensor:
    """Map non-transparent pixels to the nearest centre in LAB space.
    bug_compat reproduces color_simplify.py:544: LAB pixel coordinates
    compared against *RGB* centre coordinates."""
    rgb = rgba[..., :3].reshape(-1, 3)
    nt = rgba[..., 3].reshape(-1) > 0
    cmp_centers = (centers_rgb_u8.to(torch.float32) if bug_compat
                   else C.rgb_u8_to_lab(centers_rgb_u8))
    return map_nearest(C.rgb_u8_to_lab(rgb), cmp_centers, centers_rgb_u8, nt,
                       rgba.shape[:2])


# --------------------------------------------------------------------------
# perceptual (Ward in LAB)
# --------------------------------------------------------------------------

def simplify_colors_perceptual(
    rgba: np.ndarray,
    num_colors: int = 8,
    preserve_alpha: bool = True,
    color_tolerance: float = 30.0,
    use_gpu: bool = False,
    max_samples: int = 10000,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    _validate_rgba(rgba)
    dev = resolve_device(device)
    x = _to_device(rgba, dev)
    cap = 1 << 14  # samples <= 10000 -> unique <= 10000 < cap
    vals, counts, n_unique, n_nt = _unique_nt(x, cap, int(max_samples))
    if int(n_nt) == 0:
        return _fallback(rgba)
    n_unique = int(n_unique)
    uniq = C.unpack_rgb_u32(vals).cpu().numpy()[:n_unique]
    cnts = counts.cpu().numpy()[:n_unique]

    # Black filter over unique colors (:453-465)
    bright = uniq.astype(np.float64).mean(axis=1)
    mask = bright > 30
    if mask.sum() < num_colors:
        mask = bright > 10
    if mask.sum() == 0:
        mask = np.ones(n_unique, dtype=bool)
    filt = uniq[mask]
    cnts_f = cnts[mask]

    actual_k = min(num_colors, len(filt))
    if actual_k < 2:
        return _fallback(rgba)

    # Exact Ward on LAB of unique filtered colors (:470-523)
    lab_pad = torch.zeros((_bucket(len(filt)), 3), dtype=torch.float32,
                          device=dev)
    lab_pad[: len(filt)] = C.rgb_u8_to_lab(torch.from_numpy(filt).to(dev))
    labels = AG.ward_labels(lab_pad, len(filt), actual_k) \
        .cpu().numpy()[: len(filt)]

    # Frequency-weighted RGB centers (:526-534)
    centers = np.zeros((actual_k, 3), np.float64)
    for i in range(actual_k):
        m = labels == i
        if m.any():
            wsum = cnts_f[m].sum()
            centers[i] = (filt[m].astype(np.float64) * cnts_f[m, None]).sum(0) / max(wsum, 1)
    centers_u8 = np.clip(centers, 0, 255).astype(np.uint8)

    quantized = _map_lab_centers(x, torch.from_numpy(centers_u8).to(dev),
                                 DEFAULTS.bug_compat).cpu().numpy()
    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    return np.dstack([quantized, alpha]), centers_u8


# --------------------------------------------------------------------------
# adaptive_distance (DBSCAN in standardized LAB)
# --------------------------------------------------------------------------

def simplify_colors_adaptive_distance(
    rgba: np.ndarray,
    num_colors: int = 8,
    preserve_alpha: bool = True,
    similarity_threshold: float = 25.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    _validate_rgba(rgba)
    dev = resolve_device(device)
    LAST_SOLVE_INFO.clear()
    t0 = time.perf_counter()
    x = _to_device(rgba, dev)
    cap = 1 << 16
    vals, counts, n_unique, n_nt = _unique_nt(x, cap, None)
    if int(n_nt) == 0:
        return _fallback(rgba)
    n_unique = int(n_unique)
    if n_unique > cap:
        n_unique = cap  # extremely colorful image: operate on smallest cap colors
    uniq = C.unpack_rgb_u32(vals).cpu().numpy()[:n_unique]
    cnts = counts.cpu().numpy()[:n_unique].astype(np.float64)
    # the device-to-host copies above fence the ingest and the sort-unique
    LAST_SOLVE_INFO["t_ingest_unique"] = time.perf_counter() - t0
    LAST_SOLVE_INFO["n_unique"] = n_unique
    t0 = time.perf_counter()
    lab = C.rgb_u8_to_lab(torch.from_numpy(uniq).to(dev)).cpu().numpy() \
        .astype(np.float64)

    # Pixel-weighted black filter: L > 10, fallback L > 5, fallback all
    # (:763-772 — thresholds apply per pixel; identical colors share L).
    mask = lab[:, 0] > 10
    if (cnts[mask]).sum() < num_colors:
        mask = lab[:, 0] > 5
    if (cnts[mask]).sum() == 0:
        mask = np.ones(n_unique, dtype=bool)
    lab_f = lab[mask]
    rgb_f = uniq[mask].astype(np.float64)
    cnt_f = cnts[mask]
    nf = len(lab_f)

    # StandardScaler over filtered PIXELS == count-weighted over uniques (:782)
    wsum = cnt_f.sum()
    mean = (lab_f * cnt_f[:, None]).sum(0) / wsum
    var = (((lab_f - mean) ** 2) * cnt_f[:, None]).sum(0) / wsum
    std = np.sqrt(np.maximum(var, 1e-12))
    lab_n = (lab_f - mean) / std

    LAST_SOLVE_INFO["t_lab_filter"] = time.perf_counter() - t0
    LAST_SOLVE_INFO["n_filtered"] = nf
    t0 = time.perf_counter()
    eps = (similarity_threshold / 100.0) * 0.5
    nbuck = _bucket(nf)
    pts_pad = np.zeros((nbuck, 3), np.float32)
    pts_pad[:nf] = lab_n
    cnt_pad = np.zeros((nbuck,), np.float32)
    cnt_pad[:nf] = cnt_f
    valid_pad = np.zeros((nbuck,), bool)
    valid_pad[:nf] = True
    pts_t, cnt_t = _f32(pts_pad, dev), _f32(cnt_pad, dev)
    valid_t = torch.from_numpy(valid_pad).to(dev)
    db = DB.dbscan_labels(pts_t, cnt_t, valid_t, eps, 3.0).cpu().numpy()[:nf]
    LAST_SOLVE_INFO["t_dbscan"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    def nearest(queries: np.ndarray, refs: torch.Tensor,
                ref_valid: np.ndarray) -> np.ndarray:
        return NN.nearest_index(_f32(queries, dev), refs,
                                torch.from_numpy(ref_valid).to(dev)) \
            .cpu().numpy()

    # Noise -> nearest clustered point's label (:792-802)
    if (db == -1).any() and (db >= 0).any():
        clustered = np.pad(db, (0, nbuck - nf), constant_values=-1) >= 0
        idx = nearest(lab_n[db == -1], pts_t, valid_pad & clustered)
        db[db == -1] = db[idx]

    cluster_ids = np.unique(db[db >= 0]) if (db >= 0).any() else np.array([], int)
    n_clusters = len(cluster_ids)

    if n_clusters < num_colors:
        # k-means rescue on normalized LAB of all filtered pixels (:809-814)
        res = KM.kmeans_fit(pts_t, cnt_t, num_colors,
                            n_init=DEFAULTS.kmeans_n_init,
                            seed=DEFAULTS.kmeans_seed)
        db = nearest(lab_n, res.centers, np.ones((num_colors,), bool))
    elif n_clusters > num_colors:
        # Merge smallest into nearest-by-LAB-centroid large cluster (:817-838)
        sizes = np.array([cnt_f[db == c].sum() for c in cluster_ids])
        order = np.argsort(sizes, kind="stable")
        keep = cluster_ids[order[-num_colors:]]
        merge = cluster_ids[order[:-num_colors]]
        keep_cent = np.array([
            (lab_f[db == c] * cnt_f[db == c, None]).sum(0) / max(cnt_f[db == c].sum(), 1)
            for c in keep
        ])
        for c in merge:
            m = db == c
            cent = (lab_f[m] * cnt_f[m, None]).sum(0) / max(cnt_f[m].sum(), 1)
            tgt = keep[np.argmin(np.linalg.norm(keep_cent - cent, axis=1))]
            db[m] = tgt

    # Final centers: pixel-weighted RGB mean per cluster (:840-848)
    ids, labels_c = np.unique(db, return_inverse=True)
    labels_c = labels_c.astype(np.int64)
    kfin = len(ids)
    centers = np.zeros((kfin, 3), np.float64)
    for i in range(kfin):
        m = labels_c == i
        w = cnt_f[m]
        centers[i] = (rgb_f[m] * w[:, None]).sum(0) / max(w.sum(), 1)
    centers_u8 = np.clip(centers, 0, 255).astype(np.uint8)

    # Black (filtered-out) colors adopt the cluster of their nearest filtered
    # color in (unnormalized) LAB (:861-867).
    full_label = np.zeros(n_unique, np.int64)
    full_label[mask] = labels_c
    if (~mask).any():
        ref_pad = np.zeros((nbuck, 3), np.float32)
        ref_pad[:nf] = lab_f
        full_label[~mask] = labels_c[
            nearest(lab[~mask], _f32(ref_pad, dev), valid_pad)]

    LAST_SOLVE_INFO["t_postprocess"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_label_pad = np.zeros(cap, np.int64)
    full_label_pad[:n_unique] = full_label
    quantized = _map_via_unique(
        x, vals, torch.from_numpy(full_label_pad).to(dev),
        torch.from_numpy(centers_u8).to(dev), zero_transparent=True) \
        .cpu().numpy()
    alpha = _alpha_out_np(rgba[..., 3], preserve_alpha)
    LAST_SOLVE_INFO["t_map_d2h"] = time.perf_counter() - t0
    return np.dstack([quantized, alpha]), centers_u8
