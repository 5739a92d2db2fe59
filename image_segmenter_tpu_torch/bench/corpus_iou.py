"""The corpus acceptance run: mask IoU and palette quality on real photos.

    python -m image_segmenter_tpu_torch.bench.corpus_iou [--size 256]
        [--limit N] [--working-image PATH] [--out PATH]

Counterpart of the JAX package's bench/corpus_iou.py, on the port's compat
calls. BASELINE.json's acceptance criterion is a mask IoU >= 0.99 against
the CPU reference, and a palette that matches. For each photo of
`bench/corpus.load_corpus(size)`:

- matting: `refine_alpha_portrait(rgb, synthetic_alpha_init(rgb), None)`
  against the float64 oracle (`bench/matting_oracle`, an explicit sparse
  Levin Laplacian and a direct solve on scipy, on the host): `mask_iou` at
  127 and `alpha_mae`, with the solver's `LAST_SOLVE_INFO` timings and
  iterations;
- palette: `simplify_colors_kmeans(rgba, 16, True)` on the matted cutout
  against sklearn's KMeans(random_state=42, n_init=10) with the reference
  app's filters: the matched palette gap, label agreement through
  `linear_sum_assignment`, and `palette_quality_ok` (SSE ratio and RMS
  delta against the u8-truncated sklearn palette). Where sklearn is not
  installed (the card's machine) these fields are null and the summary
  says so;
- the sha256 of the port's alpha and palette bytes (16 hex digits);
- on the card, the same calls on the CPU of the same machine: the share of
  equal alpha bytes and the largest step between them, the mask IoU of the
  card's alpha against the CPU's, and whether the palettes are equal.
  With the sha256s, the sklearn fields of a CPU run where sklearn is
  installed (`corpus_iou_cpu.json`) carry over to the card wherever the
  two give the same bytes.

One JSON line a photo, then the summary (the JAX keys, `device`, `card`);
the record goes to `corpus_iou.json` beside this file (or `--out`). The run
is on the card unless `main(device="cpu")` is asked for, and raises
without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.bench import card_label
from image_segmenter_tpu_torch.bench.corpus import load_corpus, \
    rgb_sha256, synthetic_alpha_init
from image_segmenter_tpu_torch.bench.matting_oracle import \
    build_trimap_reference, solve_alpha_reference
from image_segmenter_tpu_torch.compat.color_simplify import \
    simplify_colors_kmeans
from image_segmenter_tpu_torch.compat.matting_refine import \
    refine_alpha_portrait
from image_segmenter_tpu_torch.solvers import matting as MAT
from image_segmenter_tpu_torch.solvers.kmeans import assign_labels
from image_segmenter_tpu_torch.utils.backend import resolve_device
from image_segmenter_tpu_torch.utils.palette import \
    matched_palette_distances, palette_quality_ok

OUT = Path(__file__).resolve().parent / "corpus_iou.json"
K = 16
MASK_AT = 127                 # the app's preview threshold: alpha > 127
IOU_FLOOR = 0.99              # BASELINE.json's acceptance
PALETTE_FIELDS = ("palette_gap", "palette_gap_wmean", "label_agreement",
                  "kmeans_sse_ratio", "kmeans_rms_delta_u8",
                  "palette_quality_ok", "rms_floor_applied")


def _log(msg: str) -> None:
    print(f"[corpus_iou] {msg}", file=sys.stderr, flush=True)


def iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def have_sklearn() -> bool:
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return False
    return True


def sklearn_kmeans_reference(rgba: np.ndarray, k: int):
    """The reference k-means path (color_simplify.py:12-102) on sklearn:
    transparent mask, brightness > 30 filter (> 10, then none, as
    fallbacks), KMeans(random_state=42, n_init=10): (centers, full-image
    labels, -1 off the fit)."""
    from sklearn.cluster import KMeans

    h, w = rgba.shape[:2]
    flat = rgba.reshape(-1, 4)
    nt = flat[:, 3] > 0
    rgbf = flat[:, :3].astype(np.float64)
    bright = rgbf.mean(axis=1)
    fit = nt & (bright > 30)
    if fit.sum() < k:
        fit = nt & (bright > 10)
        if fit.sum() == 0:
            fit = nt
    pts = rgbf[fit]
    km = KMeans(n_clusters=min(k, max(1, len(np.unique(pts, axis=0)))),
                random_state=42, n_init=10).fit(pts)
    centers = km.cluster_centers_
    d2 = ((rgbf[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    labels = d2.argmin(1)
    labels[~fit] = -1
    return centers, labels.reshape(h, w)


def palette_fields(rgba: np.ndarray, pal: np.ndarray, k: int) -> dict:
    """The port's palette against sklearn's on the same cutout (the JAX
    run's fields); null where sklearn is not installed."""
    if not have_sklearn():
        return dict.fromkeys(PALETTE_FIELDS)
    from scipy.optimize import linear_sum_assignment

    pal = np.asarray(pal, np.float64)
    ref_centers, ref_labels = sklearn_kmeans_reference(rgba, k)
    ref_flat = ref_labels.reshape(-1)
    valid = ref_flat >= 0
    ref_mass = np.bincount(ref_flat[valid], minlength=len(ref_centers))
    gap, gap_wmean = matched_palette_distances(pal, ref_centers,
                                               ref_mass.astype(np.float64))
    flat = rgba.reshape(-1, 4)
    ours = assign_labels(torch.from_numpy(flat[None, :, :3].copy()),
                         torch.from_numpy(pal[None])).numpy()[0]
    d = np.sqrt(((pal[:, None, :] - ref_centers[None, :, :]) ** 2).sum(-1))
    r, c = linear_sum_assignment(d)
    remap = np.full(len(pal), -2)
    remap[r] = c
    agree = float((remap[ours][valid] == ref_flat[valid]).mean())
    # the reference app truncates its centres to u8 (color_simplify.py:84),
    # and so does the port: compare the clustering, truncated to truncated
    ref_u8 = np.clip(ref_centers, 0, 255).astype(np.uint8).astype(np.float64)
    ok, ratio, rms = palette_quality_ok(
        flat[valid, :3].astype(np.float64), pal, ref_u8)
    return {"palette_gap": round(gap, 2),
            "palette_gap_wmean": round(gap_wmean, 2),
            "label_agreement": round(agree, 5),
            "kmeans_sse_ratio": round(ratio, 5),
            "kmeans_rms_delta_u8": round(float(rms), 3),
            "palette_quality_ok": bool(ok),
            # the absolute RMS floor, not the ratio, accepts the image
            "rms_floor_applied": bool(ok and ratio > 1.02)}


def refine_and_quantize(rgb: np.ndarray, alpha_init: np.ndarray, dev,
                        k: int = K):
    """The port's two compat calls: (alpha, palette, the solve's info,
    the refine's wall in s)."""
    t0 = time.perf_counter()
    alpha = refine_alpha_portrait(rgb, alpha_init, None, device=dev)
    t = time.perf_counter() - t0
    info = dict(MAT.LAST_SOLVE_INFO)
    _, pal = simplify_colors_kmeans(np.dstack([rgb, alpha]), k, True,
                                    device=dev)
    return alpha, np.asarray(pal), info, t


def run_image(name: str, rgb: np.ndarray, k: int = K, device="cuda") -> dict:
    """One photo's record (see the module's docstring)."""
    dev = resolve_device(device)
    alpha_init = synthetic_alpha_init(rgb)
    ours, pal, info, t_ours = refine_and_quantize(rgb, alpha_init, dev, k)

    t0 = time.perf_counter()
    tri = build_trimap_reference(alpha_init, None)
    ref01 = solve_alpha_reference(rgb.astype(np.float64) / 255.0, tri)
    ref = (ref01 * 255.0 + 0.5).astype(np.uint8)
    t_ref = time.perf_counter() - t0

    rec = {"image": name,
           "mask_iou": round(iou(ours > MASK_AT, ref > MASK_AT), 5),
           "alpha_mae": round(float(np.abs(ours.astype(int)
                                           - ref.astype(int)).mean()), 3),
           # the outputs' bytes, to hold runs on other machines to this one
           "alpha_sha256": rgb_sha256(ours)[:16],
           "palette_sha256": rgb_sha256(pal)[:16]}
    rec.update(palette_fields(np.dstack([rgb, ours]), pal, k))
    rec.update(t_ours_s=round(t_ours, 2), t_ref_s=round(t_ref, 2))
    for key in ("t_f32", "t_polish"):
        if key in info:
            rec[key + "_s"] = round(info[key], 3)
    for key in ("f32_iters", "polish_iters", "polish_converged"):
        if key in info:
            rec[key] = info[key]
    if dev.type == "cuda":
        cpu_alpha, cpu_pal, _, t_cpu = refine_and_quantize(
            rgb, alpha_init, torch.device("cpu"), k)
        step = np.abs(ours.astype(np.int32) - cpu_alpha.astype(np.int32))
        rec.update(
            card_cpu_alpha_equal=round(float((step == 0).mean()), 6),
            card_cpu_alpha_max_step=int(step.max()),
            card_cpu_mask_iou=round(iou(ours > MASK_AT, cpu_alpha > MASK_AT),
                                    6),
            card_cpu_palette_equal=bool(np.array_equal(pal, cpu_pal)),
            t_cpu_s=round(t_cpu, 2))
    return rec


def _mean_of(recs, key):
    vals = [r[key] for r in recs if key in r]
    return float(np.mean(vals)) if vals else None


def summarize(recs: list, size: int, dev: torch.device, card: str) -> dict:
    """The JAX run's summary keys, plus the device, the card and (on the
    card) the card-against-CPU agreement."""
    ious = np.array([r["mask_iou"] for r in recs])
    s = {"n_images": len(recs), "size": size,
         "mask_iou_min": float(ious.min()),
         "mask_iou_mean": float(ious.mean()),
         "frac_iou_ge_0.99": float((ious >= IOU_FLOOR).mean()),
         "images_below_0.99": [r["image"] for r in recs
                               if r["mask_iou"] < IOU_FLOOR]}
    if recs[0]["palette_quality_ok"] is None:
        s.update(dict.fromkeys((
            "label_agreement_mean", "palette_quality_all_ok",
            "n_rms_floor_applied", "kmeans_sse_ratio_max",
            "kmeans_rms_delta_u8_max", "palette_gap_wmean_max",
            "palette_gap_wmean_mean")))
        s["palette_reference"] = ("not measured: sklearn is not installed "
                                  "here; see card_cpu_palettes_equal")
    else:
        pgw = [r["palette_gap_wmean"] for r in recs]
        s.update(
            label_agreement_mean=_mean_of(recs, "label_agreement"),
            palette_quality_all_ok=all(r["palette_quality_ok"] for r in recs),
            n_rms_floor_applied=sum(r["rms_floor_applied"] for r in recs),
            kmeans_sse_ratio_max=max(r["kmeans_sse_ratio"] for r in recs),
            kmeans_rms_delta_u8_max=max(r["kmeans_rms_delta_u8"]
                                        for r in recs),
            palette_gap_wmean_max=max(pgw),
            palette_gap_wmean_mean=float(np.mean(pgw)),
            palette_reference="sklearn KMeans(random_state=42, n_init=10)")
    s.update(t_f32_mean_s=_mean_of(recs, "t_f32_s"),
             t_polish_mean_s=_mean_of(recs, "t_polish_s"))
    if dev.type == "cuda":
        s.update(
            card_cpu_alpha_equal_min=min(r["card_cpu_alpha_equal"]
                                         for r in recs),
            card_cpu_alpha_max_step=max(r["card_cpu_alpha_max_step"]
                                        for r in recs),
            card_cpu_mask_iou_min=min(r["card_cpu_mask_iou"] for r in recs),
            card_cpu_palettes_equal=all(r["card_cpu_palette_equal"]
                                        for r in recs))
    s.update(device=str(dev), card=card)
    return s


def run(size: int = 256, limit: int | None = None, working_image=None,
        device="cuda") -> dict:
    """Every photo's record and the summary; the records print as they
    come, on stdout."""
    dev = resolve_device(device)
    card = card_label(dev)
    recs = []
    for name, rgb in load_corpus(size=size, limit=limit,
                                 working_image=working_image):
        with contextlib.redirect_stdout(sys.stderr):
            rec = run_image(name, rgb, device=dev)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    return {"summary": summarize(recs, size, dev, card), "records": recs}


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.corpus_iou",
        description="Mask IoU against the float64 oracle and palette "
                    "quality against sklearn on the photo corpus.")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--working-image", metavar="PATH",
                    help="the reference app's working image (needs Pillow)")
    ap.add_argument("--out", default=str(OUT), help="the record's path")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run(args.size, args.limit, args.working_image, device)
    res["summary"]["elapsed_s"] = time.perf_counter() - t0
    print(json.dumps(res["summary"]), flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    _log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
