"""GrabCut parity sweep of the port against cv2.grabCut, on the CPU.

    python -m image_segmenter_tpu_torch.bench.grabcut_parity \
        [--working-image PATH]

Counterpart of the JAX package's bench/grabcut_parity.py, on the port's
`compat.grabcut.apply_grabcut(device="cpu")`. The same cases: 12
structured scenes (`scene`, seeds 1000-1011, noise 6-20) with the rect
(8, 8, w - 16, h - 16) and with a mask init, plus the real-photo corpus
with the rect, 10 iterations each (`bench/corpus.load_corpus` at 96, the
photos and bytes of tests/helpers/corpus.py; the reference app's working
image joins them where `--working-image` gives its path). For every case:

- the foreground IoU against cv2;
- the GrabCut energy of both masks under one common model (GMMs fit to
  the mask's own partition, plus the cut n-links: the port's
  `solvers/grabcut.mask_energy`, the judge the split-merge polish uses);
- the JAX package's own `e_ours` and `fg_frac_ours` for the case, read as
  data from its records file (root bench/grabcut_parity.json), where
  present.

The summary (and one by kind, degenerate scenes apart: a foreground
fraction outside (0.005, 0.995) for either solver) stands beside the JAX
package's. Cases where the port's energy exceeds both cv2's and the JAX
package's by more than 1e-4 relative are listed under
`energy_above_cv2_and_jax`. Writes `grabcut_parity.json` beside this file.
Needs cv2; a side program run by hand, not a test (minutes on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.corpus import load_corpus
from image_segmenter_tpu_torch.compat.grabcut import apply_grabcut
from image_segmenter_tpu_torch.solvers import grabcut as GC

N_SCENES = 12
ITERS = 10
GAP = 1e-4   # relative energy gap under which two masks count as equal
OUT = Path(__file__).resolve().parent / "grabcut_parity.json"
# the JAX package's records of the same sweep, read as data
JAX_RECORDS = Path(__file__).resolve().parents[2] / "bench" / \
    "grabcut_parity.json"
DEGENERATE = (0.005, 0.995)


def scene(rng, h: int = 72, w: int = 96, noise: float = 12.0,
          fg_shift: float = 140.0):
    """A noisy elliptic blob of a random colour on a flat noisy background:
    (BGR u8 (h, w, 3), blob mask). The JAX sweep's `_scene`, draw for draw."""
    img = np.zeros((h, w, 3), np.float64)
    img[...] = [40, 90, 160]
    img += rng.normal(0, noise, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    cy = h / 2 + rng.uniform(-h / 8, h / 8)
    cx = w / 2 + rng.uniform(-w / 8, w / 8)
    ry = h / rng.uniform(2.8, 3.8)
    rx = w / rng.uniform(2.8, 4.0)
    blob = ((yy - cy) ** 2 / ry**2 + (xx - cx) ** 2 / rx**2) < 1
    fg = np.clip(np.array([40, 90, 160]) + rng.uniform(-1, 1, 3) * fg_shift,
                 0, 255)
    img[blob] = fg.astype(np.uint8)
    img[blob] = np.clip(
        img[blob].astype(int) + rng.normal(0, noise, (blob.sum(), 3)), 0, 255)
    return np.clip(img, 0, 255).astype(np.uint8), blob


def scene_case(s: int):
    """Scene s of the sweep: (BGR, blob, noise)."""
    rng = np.random.default_rng(1000 + s)
    noise = rng.uniform(6, 20)
    img, blob = scene(rng, noise=noise)
    return img, blob, noise


def rect_of(img) -> tuple:
    h, w = img.shape[:2]
    return (8, 8, w - 16, h - 16)


def mask_init(blob: np.ndarray) -> np.ndarray:
    """The sweep's mask init: the blob probable foreground, the rest
    probable background, the top rows background, a centre seed sure
    foreground."""
    h, w = blob.shape
    init = np.full((h, w), GC.PR_BGD, np.uint8)
    init[blob] = GC.PR_FGD
    init[:4, :] = GC.BGD
    cy, cx = h // 2, w // 2
    init[cy - 3:cy + 3, cx - 3:cx + 3] = GC.FGD
    return init


def energy(img_bgr: np.ndarray, fg: np.ndarray) -> float:
    """The common model's GrabCut energy of a hard foreground mask."""
    im = GC.prepare(torch.from_numpy(np.ascontiguousarray(img_bgr)))
    return float(GC.mask_energy(
        im, torch.from_numpy(fg.astype(np.float32))[None])[0])


def ours(img, rect=None, init_mask=None, iters: int = ITERS) -> np.ndarray:
    """The port's mask on the CPU."""
    return apply_grabcut(img, rect_xywh=rect, init_mask=init_mask,
                         iterations=iters, device="cpu")


def _fg(m: np.ndarray) -> np.ndarray:
    return (m == GC.FGD) | (m == GC.PR_FGD)


def _iou(a, b) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def run_case(img, rect=None, init_mask=None, iters: int = ITERS) -> dict:
    import cv2

    h, w = img.shape[:2]
    t0 = time.perf_counter()
    fg_ours = _fg(ours(img, rect, init_mask, iters))
    t_ours = time.perf_counter() - t0
    ref = np.zeros((h, w), np.uint8) if init_mask is None \
        else init_mask.copy()
    mode = cv2.GC_INIT_WITH_RECT if rect is not None \
        else cv2.GC_INIT_WITH_MASK
    cv2.grabCut(img, ref, rect, np.zeros((1, 65)), np.zeros((1, 65)), iters,
                mode)
    fg_ref = _fg(ref)
    return {"iou": _iou(fg_ours, fg_ref),
            "e_ours": energy(img, fg_ours), "e_cv2": energy(img, fg_ref),
            "fg_frac_ours": float(fg_ours.mean()),
            "fg_frac_cv2": float(fg_ref.mean()), "s_ours": t_ours}


def _gap(e, e_ref) -> float:
    return (e - e_ref) / max(abs(e_ref), 1)


def degenerate(r: dict) -> bool:
    lo, hi = DEGENERATE
    return not (lo < r["fg_frac_ours"] < hi and lo < r["fg_frac_cv2"] < hi)


def summarize(rs: list) -> dict:
    """The JAX sweep's summary of a list of records."""
    if not rs:
        return {"n": 0}
    ious = np.array([r["iou"] for r in rs])
    e_gap = np.array([_gap(r["e_ours"], r["e_cv2"]) for r in rs])
    return {"n": len(rs),
            "iou_mean": float(ious.mean()),
            "iou_min": float(ious.min()),
            "iou_p10": float(np.percentile(ious, 10)),
            "frac_iou_ge_0.99": float((ious >= 0.99).mean()),
            "frac_energy_ours_le_cv2": float((e_gap <= GAP).mean()),
            "rel_energy_gap_mean": float(e_gap.mean()),
            "frac_iou_or_energy_ok": float(
                ((ious >= 0.99) | (e_gap <= GAP)).mean())}


def by_kind(records: list) -> dict:
    out = {}
    for kind in sorted({r["kind"] for r in records}):
        ks = [r for r in records if r["kind"] == kind]
        out[kind] = summarize([r for r in ks if not degenerate(r)])
        deg = [r for r in ks if degenerate(r)]
        if deg:
            out[kind + "-degenerate"] = summarize(deg)
    return out


def cases(n_scenes: int = N_SCENES, working_image=None):
    """(scene, kind, BGR, rect, init mask, extra fields) of every case."""
    for s in range(n_scenes):
        img, blob, noise = scene_case(s)
        yield s, "rect", img, rect_of(img), None, {"noise": round(noise, 1)}
        yield s, "mask", img, None, mask_init(blob), {"noise": round(noise, 1)}
    for name, rgb in load_corpus(96, working_image=working_image):
        img = np.ascontiguousarray(rgb[:, :, ::-1])
        yield name, "photo-rect", img, rect_of(img), None, {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.grabcut_parity",
        description="The port's GrabCut against cv2 on the JAX sweep's cases.")
    ap.add_argument("--working-image", metavar="PATH",
                    help="the reference app's app/working_image_cleaned.bmp, "
                         "a corpus case")
    args = ap.parse_args(argv)
    recorded = json.loads(JAX_RECORDS.read_text()) \
        if JAX_RECORDS.exists() else None
    by_case = {} if recorded is None else {
        (str(r["scene"]), r["kind"]): r for r in recorded["records"]}
    t0 = time.time()
    records = []
    for s, kind, img, rect, init, extra in cases(
            working_image=args.working_image):
        rec = run_case(img, rect, init)
        rec.update(scene=s, kind=kind, **extra)
        ref = by_case.get((str(s), kind))
        if ref is not None:
            rec["jax_e_ours"] = ref["e_ours"]
            rec["jax_fg_frac_ours"] = ref["fg_frac_ours"]
        records.append(rec)
        print(json.dumps(rec), flush=True)
    summary = summarize(records)
    summary["elapsed_s"] = time.time() - t0
    above = [{"scene": r["scene"], "kind": r["kind"], "e_ours": r["e_ours"],
              "e_cv2": r["e_cv2"], "jax_e_ours": r["jax_e_ours"]}
             for r in records if "jax_e_ours" in r
             and _gap(r["e_ours"], r["e_cv2"]) > GAP
             and _gap(r["e_ours"], r["jax_e_ours"]) > GAP]
    out = {"device": "cpu", "torch": torch.__version__, "iterations": ITERS,
           "summary": summary, "summary_by_class": by_kind(records),
           "jax_summary": None if recorded is None else recorded["summary"],
           "jax_summary_by_class": None if recorded is None
           else recorded["summary_by_class"],
           "energy_above_cv2_and_jax": above, "records": records}
    print(json.dumps({"port": summary, "jax": out["jax_summary"],
                      "energy_above_cv2_and_jax": above}), flush=True)
    OUT.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
