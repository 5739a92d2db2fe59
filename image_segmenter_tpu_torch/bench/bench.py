"""The port's headline: the main path's MP/s on a batch of 4K frames.

    python -m image_segmenter_tpu_torch.bench.bench

Counterpart of the JAX package's root bench.py. Runs
`Pipeline(model=BENCH_MODEL, k=16).run` (background removal -> matting
refine -> 16-colour k-means) on a batch of real photos and prints exactly
ONE line on stdout, the last, a JSON object:

    {"metric": "pipeline_u2netp_matting_kmeans16_2160x3840_b4_photo",
     "value": MP/s streaming, "unit": "MP/sec/chip", "vs_baseline": value / 50,
     "ms_per_batch": ..., "spread": {"min": ..., "max": ...},
     "device_resident_mp_s": ..., "device_resident_ms_per_batch": ...,
     "device_resident_spread": {...}, "rounds": 5, "reps": ...,
     "content": "photo", "h2d_gbs": {"pre": ..., "post": ...},
     "card": "<name>, <power limit>", "device": "cuda", "launches": {...}}

Everything else goes to stderr. Settings, the JAX bench's names and
defaults: BENCH_H 2160, BENCH_W 3840, BENCH_BATCH 4, BENCH_REPS 5,
BENCH_MODEL u2netp, BENCH_SECONDARY isnet-general-use ("none" skips it),
BENCH_PHOTO 1.

- Content, as the JAX bench's: the headline is the photo mosaic
  (`photo_batch`: the corpus of `bench/corpus.py` at 1080 x 1080 tiled by
  the JAX rule, BASELINE config 5's content). It runs first, so its cold
  stamps are cold. The synthetic batch (`synthetic_batch`, one seeded
  gradient-plus-noise image broadcast) follows with max(2, BENCH_REPS // 2)
  calls a round, its record on stderr as `[bench] synthetic {...}`.
  BENCH_PHOTO=0 runs the synthetic batch alone, on stdout, with
  `"content": "synthetic"` and the metric without `_photo`. A missing or
  corrupt corpus file raises: no run falls back to other content.
- Cold stamps (stderr): the kernels' build, or the load of the library a
  build left, and the first call.
- Streaming (`value`): `ROUNDS` rounds of BENCH_REPS calls, each call
  given the batch as host numpy (the copy to the card is in the time),
  synchronised once a round; the median round's ms a batch and the
  min-max spread of the rounds.
- Device-resident: the same with the batch already a tensor on the card.
- Host-to-device rate: 24 MB copied from pageable host memory, best of 4,
  before and after the runs; null on the CPU.
- `launches`: each main-path kernel's launches in one warm run (K1
  histogram, K2 precompute, K3 matvec, K4 quantize); zero on the CPU,
  where the plain versions run.
- Secondary model: on the synthetic batch, as the JAX bench's; its
  record on stderr after the headline is printed; a failure there still
  exits non-zero.

The bench runs on the card unless `main(device="cpu")` is asked for, and
raises without a card; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.corpus import load_corpus
from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ
from image_segmenter_tpu_torch.utils.backend import resolve_device

ROUNDS = 5
BASELINE_MP_S = 50.0          # BASELINE.md's target, MP/s a chip
H2D_MB = 24
H2D_TRIES = 4
TILE = 1080                   # the photo mosaic's tile side
# the main path's kernels and their launch counters
MAIN_PATH_KERNELS = {"histogram": KH, "precompute": KP, "matvec": KMV,
                     "quantize": KQ}
FIELDS = ("metric", "value", "unit", "vs_baseline", "ms_per_batch", "spread",
          "device_resident_mp_s", "device_resident_ms_per_batch",
          "device_resident_spread", "rounds", "reps", "content", "h2d_gbs",
          "card", "device", "launches")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def synthetic_batch(b: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """bench.py's content: one seeded image of smooth gradients and
    sensor-like noise, broadcast to a (b, h, w, 3) uint8 batch."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([
        127 + 100 * np.sin(xx / 97.0) * np.cos(yy / 53.0),
        127 + 100 * np.cos(xx / 131.0),
        127 + 100 * np.sin((xx + yy) / 173.0),
    ], axis=-1)
    img = np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)
    return np.broadcast_to(img, (b, h, w, 3)).copy()


def photo_batch(b: int, h: int, w: int) -> np.ndarray:
    """root bench.py's photo mosaic: (b, h, w, 3) u8, image i tiled from
    the corpus at TILE x TILE row by row, tile (i + r * cols + c) % (the
    number of photos) at row r and column c, cropped to (h, w)."""
    cols, rows = -(-w // TILE), -(-h // TILE)
    # the highest index is b - 1 + rows * cols - 1: below the corpus's
    # length the modulus takes nothing, past it every photo is needed
    tiles = load_corpus(size=TILE, limit=b + rows * cols - 1)
    out = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        canvas = np.concatenate([
            np.concatenate([tiles[(i + r * cols + c) % len(tiles)][1]
                            for c in range(cols)], axis=1)
            for r in range(rows)], axis=0)
        out[i] = canvas[:h, :w]
    return out


def card_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"
    for a run on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[dev.index or 0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def h2d_gbs(dev: torch.device, mb: int = H2D_MB,
            tries: int = H2D_TRIES) -> float | None:
    """Host-to-device rate in GB/s (GiB as the JAX bench counts them),
    best of `tries` copies of `mb` MiB from pageable memory; None on the
    CPU, which has no such copy."""
    if dev.type != "cuda":
        return None
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (mb * 1024 * 1024,), dtype=np.uint8))
    best = 0.0
    for _ in range(tries):
        sync(dev)
        t0 = time.perf_counter()
        d = x.to(dev)
        sync(dev)
        best = max(best, mb / 1024 / (time.perf_counter() - t0))
        del d
    return best


def launches_of(fn, dev: torch.device):
    """(fn's result, the main-path kernels' launches while it ran)."""
    before = {n: m.LAUNCHES for n, m in MAIN_PATH_KERNELS.items()}
    out = fn()
    sync(dev)
    return out, {n: m.LAUNCHES - before[n]
                 for n, m in MAIN_PATH_KERNELS.items()}


def timed_calls(fn, dev: torch.device, reps: int):
    """One warm call, then `reps` calls each synchronised on its own:
    (the last output, the seconds of each)."""
    out = fn()
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return out, times


def timed_round(run, dev: torch.device, reps: int):
    """`reps` calls of run() synchronised once at the end: (seconds a
    call, the last call's output)."""
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    sync(dev)
    return (time.perf_counter() - t0) / reps, out


def stream_round(pipe, imgs: np.ndarray, reps: int):
    """One streaming round: every call takes the batch as host numpy."""
    return timed_round(lambda: pipe.run(imgs), pipe.device, reps)


def _rounds(one_round, rounds: int) -> dict:
    times = [one_round()[0] for _ in range(rounds)]
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "all": times}


def measure(pipe, model: str, imgs: np.ndarray, reps: int,
            rounds: int = ROUNDS, tag: str = "",
            content: str = "synthetic") -> dict:
    """Cold call, warm counted call, streaming and device-resident rounds
    of `pipe` (of `model`) on `imgs` (`content`: "photo" adds `_photo` to
    the metric): the record without the run's `h2d_gbs` and `card`."""
    dev = pipe.device
    b, h, w = imgs.shape[:3]
    mp = b * h * w / 1e6
    t0 = time.perf_counter()
    pipe.run(imgs)
    sync(dev)
    log(f"{tag}first call (cold: cuDNN plans, allocator, weights): "
        f"{time.perf_counter() - t0:.3f} s")
    _, launches = launches_of(lambda: pipe.run(imgs), dev)
    log(f"{tag}kernel launches in one run: {launches}")

    stream = _rounds(lambda: stream_round(pipe, imgs, reps), rounds)
    x = torch.from_numpy(imgs).to(dev)
    pipe.run(x)  # warm for a resident input
    resident = _rounds(lambda: timed_round(lambda: pipe.run(x), dev, reps),
                       rounds)
    del x
    for name, r in (("streaming", stream), ("device-resident", resident)):
        log(f"{tag}{name}: ms a batch by round "
            f"{[round(t * 1e3, 3) for t in r['all']]} ({reps} calls a round); "
            f"median {r['median'] * 1e3:.3f} ms, {mp / r['median']:.3f} MP/s")

    def ms(t):
        return t * 1e3

    value = mp / stream["median"]
    suffix = "_photo" if content == "photo" else ""
    return {
        "metric": f"pipeline_{model}_matting_kmeans16_{h}x{w}_b{b}{suffix}",
        "value": value,
        "unit": "MP/sec/chip",
        "vs_baseline": value / BASELINE_MP_S,
        "ms_per_batch": ms(stream["median"]),
        "spread": {"min": ms(stream["min"]), "max": ms(stream["max"])},
        "device_resident_mp_s": mp / resident["median"],
        "device_resident_ms_per_batch": ms(resident["median"]),
        "device_resident_spread": {"min": ms(resident["min"]),
                                   "max": ms(resident["max"])},
        "rounds": rounds,
        "reps": reps,
        "content": content,
        "device": str(dev),
        "launches": launches,
    }


def settings() -> dict:
    env = os.environ
    return {"h": int(env.get("BENCH_H", 2160)),
            "w": int(env.get("BENCH_W", 3840)),
            "batch": int(env.get("BENCH_BATCH", 4)),
            "reps": int(env.get("BENCH_REPS", 5)),
            "model": env.get("BENCH_MODEL", "u2netp"),
            "secondary": env.get("BENCH_SECONDARY", "isnet-general-use"),
            "photo": env.get("BENCH_PHOTO", "1") != "0"}


def main(argv=None, device="cuda") -> int:
    argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.bench",
        description="The main path's MP/s; set BENCH_H, BENCH_W, "
                    "BENCH_BATCH, BENCH_REPS, BENCH_MODEL, BENCH_SECONDARY, "
                    "BENCH_PHOTO."
    ).parse_args(argv)
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    dev = resolve_device(device)
    cfg = settings()
    with contextlib.redirect_stdout(sys.stderr):
        card = card_label(dev)
        log(f"device {dev} ({card}), torch {torch.__version__}, settings "
            f"{cfg}")
        if dev.type == "cuda":
            from image_segmenter_tpu_torch.kernels import _build

            t0 = time.perf_counter()
            _build.library()
            log(f"kernel build (or load of a cached build): "
                f"{time.perf_counter() - t0:.3f} s")
        h2d_pre = h2d_gbs(dev)
        log(f"host-to-device (before the runs): {h2d_pre} GB/s")
        b, h, w = cfg["batch"], cfg["h"], cfg["w"]
        pipe = Pipeline(model=cfg["model"], k=16, device=dev)
        recs = []
        if cfg["photo"]:
            t0 = time.perf_counter()
            photos = photo_batch(b, h, w)
            log(f"photo mosaic {b}x{h}x{w} from the corpus: "
                f"{time.perf_counter() - t0:.3f} s")
            recs.append(measure(pipe, cfg["model"], photos, cfg["reps"],
                                tag="photo: ", content="photo"))
            del photos
        imgs = synthetic_batch(b, h, w)
        reps = max(2, cfg["reps"] // 2) if recs else cfg["reps"]
        recs.append(measure(pipe, cfg["model"], imgs, reps,
                            tag="synthetic: " if recs else ""))
        del pipe
        h2d_post = h2d_gbs(dev)
        log(f"host-to-device (after the runs): {h2d_post} GB/s")
        for r in recs:
            r.update(h2d_gbs={"pre": h2d_pre, "post": h2d_post}, card=card)
        rec, *rest = [{k: r[k] for k in FIELDS} for r in recs]
        for r in rest:
            log(f"synthetic {json.dumps(r)}")
    # the headline goes out before the secondary model can fail
    print(json.dumps(rec), flush=True)

    secondary = cfg["secondary"]
    if secondary in ("", "none", cfg["model"]):
        return 0
    with contextlib.redirect_stdout(sys.stderr):
        try:
            pipe = Pipeline(model=secondary, k=16, device=dev)
            sec = measure(pipe, secondary, imgs, max(2, cfg["reps"] // 2),
                          tag=f"{secondary}: ")
        except Exception:  # the headline is out; report and fail the run
            log(f"secondary {secondary} failed:\n{traceback.format_exc()}")
            return 1
        log(f"secondary {json.dumps(sec)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
