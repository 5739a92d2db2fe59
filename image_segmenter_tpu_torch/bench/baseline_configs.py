"""Measured MP/s of the five BASELINE configs on the port.

    python -m image_segmenter_tpu_torch.bench.baseline_configs

Counterpart of the JAX package's bench/baseline_configs.py. Each config is
a function that takes its sizes (BASELINE's by default) and `device`:

1. `kmeans` k 16 at 1024 x 1024 (simplify_colors_kmeans);
2. median_cut, octree and threshold (k 8) on a 1080 x 1920 batch of 4;
3. perceptual, adaptive_distance and hsv_clustering (k 8) at 2160 x 3840,
   with the stage stamps (`LAST_SOLVE_INFO`) of the last two;
4. apply_grabcut (config 4's rect, 10 iterations) and
   refine_alpha_portrait on three 1024 x 768 portraits, with both
   solvers' stamps;
5. the main path, `Pipeline(model="u2netp", k=16).run` on a 4 x 2160 x
   3840 batch given as host numpy (streaming).

Protocol, as the JAX script's: one warm call, then the least wall of
BENCH_CFG_REPS (default 3) calls; every time is listed. The compat entry
points return numpy, so a time holds the copies both ways.

Content, named in each record: config 1 takes the reference app's
working image (app/working_image_cleaned.bmp, 1024 x 1024) where it is
given with `--working-image PATH` (read with Pillow), otherwise
`quantizer_frame` (photo-like RGBA with a transparent corner, a semi-
transparent band and a dark patch; chip_smoke phase 9's). Configs 2, 3
and 5 take bench.py's synthetic image (`bench.synthetic_batch`), config
2 seeds 0-3. Config 4 takes seeded portrait scenes
(`utils/seeds.portrait_scene`, seeds 21-23, chip_smoke phase 10's), the
refine's alpha the drawn subject blurred by a Gaussian of sigma 1.5: the
JAX script's corpus crops need Pillow and photo files.

`main` writes the record, with the card's name and power limit, to
`baseline_configs.json` beside this file and prints one stdout line,
{config: MP/s}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.bench import card_label, h2d_gbs, \
    synthetic_batch, timed_calls
from image_segmenter_tpu_torch.bench.micro_precompute_hist import photo_batch
from image_segmenter_tpu_torch.utils.backend import resolve_device

REPS = int(os.environ.get("BENCH_CFG_REPS", 3))
OUT = Path(__file__).resolve().parent / "baseline_configs.json"
PORTRAIT_SEEDS = (21, 22, 23)


def _log(msg: str) -> None:
    print(f"[baseline_configs] {msg}", file=sys.stderr, flush=True)


def quantizer_frame(h: int, w: int, seed: int, mask: int = 0xFF) -> np.ndarray:
    """Photo-like RGBA with a transparent corner, a semi-transparent band
    and a dark patch; `mask` drops low colour bits (fewer unique colours)."""
    rgb = photo_batch(1, h, w, seed)[0] & np.uint8(mask)
    rgba = np.dstack([rgb, np.full((h, w), 255, np.uint8)])
    rgba[: h // 5, : w // 4, 3] = 0
    rgba[h // 3: h // 3 + h // 10, :, 3] = 100
    dark = rgba[2 * h // 3: 5 * h // 6, w // 2: 5 * w // 6, :3]
    dark //= 24
    return np.ascontiguousarray(rgba)


def _opaque(rgb: np.ndarray) -> np.ndarray:
    return np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])


def _timed(fn, dev, reps: int) -> dict:
    """One warm call, then `reps` timed ones: the least and every wall."""
    _, times = timed_calls(fn, dev, reps)
    return {"s": min(times), "times_s": times}


def _stamps(info: dict) -> dict:
    return {k: v for k, v in info.items()
            if isinstance(v, (int, float, str, bool, list))}


def read_rgb(path) -> np.ndarray:
    """An image file as (H, W, 3) u8 RGB, read with Pillow."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def config_1(h: int = 1024, w: int = 1024, reps: int = REPS, device="cuda",
             image=None, image_name: str = "given image") -> dict:
    """kmeans k 16 on `image` ((H, W, 3) u8 RGB, made opaque) where one is
    given, else on `quantizer_frame(h, w)`."""
    from image_segmenter_tpu_torch.compat.color_simplify import \
        simplify_colors_kmeans

    dev = resolve_device(device)
    if image is not None:
        rgba = _opaque(image)
        h, w = image.shape[:2]
        content = f"{image_name} {h}x{w}"
    else:
        content = f"quantizer_frame({h}, {w}, seed 11)"
        rgba = quantizer_frame(h, w, seed=11)
    mp = h * w / 1e6
    t = _timed(lambda: simplify_colors_kmeans(rgba, 16, True, device=dev),
               dev, reps)
    _log(f"config 1: kmeans k 16 {h}x{w} {t['s'] * 1e3:.3f} ms ({content})")
    return {"config": 1, "desc": f"kmeans k 16, {h}x{w}", "content": content,
            "mp_per_call": mp, "s_per_call": t["s"], "times_s": t["times_s"],
            "mp_s": mp / t["s"]}


def config_2(h: int = 1080, w: int = 1920, b: int = 4, reps: int = REPS,
             device="cuda") -> dict:
    """median_cut, octree and threshold (k 8) on a batch of b frames."""
    from image_segmenter_tpu_torch.compat import color_simplify as CS

    dev = resolve_device(device)
    imgs = [_opaque(synthetic_batch(1, h, w, seed=i)[0]) for i in range(b)]
    mp = b * h * w / 1e6
    per = {}
    for name, fn in (("median_cut", CS.simplify_colors_median_cut),
                     ("octree", CS.simplify_colors_octree),
                     ("threshold", CS.simplify_colors_threshold)):
        t = _timed(lambda: [fn(im, 8, True, device=dev) for im in imgs],
                   dev, reps)
        per[name] = {"s_per_batch": t["s"], "times_s": t["times_s"],
                     "mp_s": mp / t["s"]}
        _log(f"config 2: {name} {b}x{h}x{w} {t['s'] * 1e3:.3f} ms = "
             f"{mp / t['s']:.3f} MP/s")
    total = sum(v["s_per_batch"] for v in per.values())
    return {"config": 2, "desc": f"median_cut+octree+threshold, {h}x{w} "
            f"batch {b}", "content": f"synthetic (bench.py's image), seeds "
            f"0-{b - 1}", "mp_per_batch": mp, "per_algorithm": per,
            "mp_s": 3 * mp / total}


def config_3(h: int = 2160, w: int = 3840, reps: int = REPS,
             device="cuda") -> dict:
    """perceptual, adaptive_distance and hsv_clustering (k 8)."""
    from image_segmenter_tpu_torch.compat import _perceptual as PC
    from image_segmenter_tpu_torch.compat import color_simplify as CS

    dev = resolve_device(device)
    rgba = _opaque(synthetic_batch(1, h, w)[0])
    mp = h * w / 1e6
    algos = (("perceptual", CS.simplify_colors_perceptual, None),
             ("adaptive_distance", CS.simplify_colors_adaptive_distance, PC),
             ("hsv_clustering", CS.simplify_colors_hsv_clustering, CS))
    per = {}
    for name, fn, info in algos:
        t = _timed(lambda: fn(rgba, 8, True, device=dev), dev, reps)
        per[name] = {"s_per_call": t["s"], "times_s": t["times_s"],
                     "mp_s": mp / t["s"]}
        if info is not None:
            per[name]["last_solve_info"] = _stamps(info.LAST_SOLVE_INFO)
        _log(f"config 3: {name} {h}x{w} {t['s'] * 1e3:.3f} ms "
             f"{per[name].get('last_solve_info', '')}")
    total = sum(v["s_per_call"] for v in per.values())
    return {"config": 3, "desc": f"perceptual+adaptive_distance+"
            f"hsv_clustering, {h}x{w}", "content": "synthetic (bench.py's "
            "image), seed 0", "mp_per_call": mp, "per_algorithm": per,
            "mp_s": 3 * mp / total}


def portrait_alpha(subject: np.ndarray) -> np.ndarray:
    """A segmentation net's soft alpha for a drawn subject: the mask
    blurred by a Gaussian of sigma 1.5, as u8."""
    from scipy.ndimage import gaussian_filter

    soft = gaussian_filter(subject.astype(np.float64) * 255.0, 1.5)
    return np.clip(soft, 0, 255).astype(np.uint8)


def config_4(h: int = 1024, w: int = 768, iterations: int = 10,
             seeds=PORTRAIT_SEEDS, reps: int = REPS, device="cuda") -> dict:
    """apply_grabcut (rect, `iterations`) and refine_alpha_portrait on
    seeded portraits."""
    from image_segmenter_tpu_torch.compat.grabcut import apply_grabcut
    from image_segmenter_tpu_torch.compat.matting_refine import \
        refine_alpha_portrait
    from image_segmenter_tpu_torch.solvers import grabcut as GC
    from image_segmenter_tpu_torch.solvers import matting as MAT
    from image_segmenter_tpu_torch.utils.seeds import config4_rect, \
        portrait_scene

    dev = resolve_device(device)
    scenes = [portrait_scene(h, w, s) for s in seeds]
    rect = config4_rect(h, w)
    mp = len(scenes) * h * w / 1e6

    def grabcut():
        for bgr, _ in scenes:
            apply_grabcut(bgr, rect_xywh=rect, iterations=iterations,
                          device=dev)

    alphas = [portrait_alpha(subject) for _, subject in scenes]

    def matting():
        for (bgr, _), a in zip(scenes, alphas):
            refine_alpha_portrait(np.ascontiguousarray(bgr[..., ::-1]), a,
                                  None, device=dev)

    t_gc = _timed(grabcut, dev, reps)
    gc_info = _stamps(GC.LAST_SOLVE_INFO)
    _log(f"config 4: grabcut x{len(scenes)} {t_gc['s'] * 1e3:.3f} ms "
         f"(last solve: {gc_info})")
    t_mt = _timed(matting, dev, reps)
    mt_info = _stamps(MAT.LAST_SOLVE_INFO)
    _log(f"config 4: matting x{len(scenes)} {t_mt['s'] * 1e3:.3f} ms "
         f"(last solve: {mt_info})")
    return {"config": 4, "desc": f"grabcut({iterations} iterations)+matting, "
            f"{len(scenes)} portraits {h}x{w}",
            "content": f"utils/seeds.portrait_scene seeds {list(seeds)}; "
            "refine alpha: the subject blurred, sigma 1.5",
            "mp_total": mp,
            "grabcut": {"s": t_gc["s"], "times_s": t_gc["times_s"],
                        "mp_s": mp / t_gc["s"], "last_solve_info": gc_info},
            "matting": {"s": t_mt["s"], "times_s": t_mt["times_s"],
                        "mp_s": mp / t_mt["s"], "last_solve_info": mt_info},
            "mp_s": 2 * mp / (t_gc["s"] + t_mt["s"])}


def config_5(b: int = 4, h: int = 2160, w: int = 3840, reps: int = REPS,
             device="cuda") -> dict:
    """The main path, the batch given as host numpy on every call."""
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    dev = resolve_device(device)
    imgs = synthetic_batch(b, h, w)
    mp = b * h * w / 1e6
    pipe = Pipeline(model="u2netp", k=16, device=dev)
    t = _timed(lambda: pipe.run(imgs), dev, reps)
    _log(f"config 5: main path {b}x{h}x{w} {t['s'] * 1e3:.3f} ms = "
         f"{mp / t['s']:.3f} MP/s")
    return {"config": 5, "desc": f"u2netp->matting->kmeans16, {b}x{h}x{w}, "
            "streaming (host numpy in on every call)",
            "content": "synthetic (bench.py's image), seed 0",
            "mp_per_batch": mp, "s_per_batch": t["s"],
            "times_s": t["times_s"], "mp_s": mp / t["s"]}


CONFIGS = (config_1, config_2, config_3, config_4, config_5)


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.baseline_configs",
        description="The five BASELINE configs; BENCH_CFG_REPS sets the "
                    "timed calls of each.")
    ap.add_argument("--working-image", metavar="PATH",
                    help="config 1's image: the reference app's "
                         "app/working_image_cleaned.bmp (needs Pillow)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    with contextlib.redirect_stdout(sys.stderr):
        card = card_label(dev)
        _log(f"device {dev} ({card}), torch {torch.__version__}, reps {REPS}")
        h2d_pre = h2d_gbs(dev)
        t0 = time.perf_counter()
        first = {} if args.working_image is None else {
            "image": read_rgb(args.working_image),
            "image_name": os.path.basename(args.working_image)}
        configs = [config_1(device=dev, **first)]
        configs += [cfg(device=dev) for cfg in CONFIGS[1:]]
        elapsed = time.perf_counter() - t0
        h2d_post = h2d_gbs(dev)
        out = {"device": str(dev), "card": card,
               "torch": torch.__version__, "reps": REPS,
               "h2d_gbs": {"pre": h2d_pre, "post": h2d_post},
               "elapsed_s": elapsed,
               "note": "least wall of `reps` calls after one warm call, "
                       "host clock around synchronised calls; the compat "
                       "calls take and give numpy",
               "configs": configs}
        with open(OUT, "w") as f:
            json.dump(out, f, indent=1)
        _log(f"wrote {OUT}")
    print(json.dumps({c["config"]: c["mp_s"] for c in configs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
