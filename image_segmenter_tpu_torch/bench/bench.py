"""The port's headline: the main path's MP/s on a batch of 4K frames.

    python -m image_segmenter_tpu_torch.bench.bench

Counterpart of the JAX package's root bench.py. Runs
`Pipeline(model=BENCH_MODEL, k=16).run` (background removal -> matting
refine -> 16-colour k-means) on a synthetic batch and prints exactly ONE
line on stdout, the last, a JSON object:

    {"metric": "pipeline_u2netp_matting_kmeans16_2160x3840_b4",
     "value": MP/s streaming, "unit": "MP/sec/chip", "vs_baseline": value / 50,
     "ms_per_batch": ..., "spread": {"min": ..., "max": ...},
     "device_resident_mp_s": ..., "device_resident_ms_per_batch": ...,
     "device_resident_spread": {...}, "rounds": 5, "reps": ...,
     "content": "synthetic", "h2d_gbs": {"pre": ..., "post": ...},
     "card": "<name>, <power limit>", "device": "cuda", "launches": {...}}

Everything else goes to stderr. Settings, the JAX bench's names and
defaults: BENCH_H 2160, BENCH_W 3840, BENCH_BATCH 4, BENCH_REPS 5,
BENCH_MODEL u2netp, BENCH_SECONDARY isnet-general-use ("none" skips it).

- Content: bench.py's synthetic batch (`synthetic_batch`), one seeded
  gradient-plus-noise image broadcast to the batch. The JAX bench's photo
  mosaic needs Pillow and photo files that a card machine does not have.
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
- Secondary model: its record on stderr after the headline is printed;
  a failure there still exits non-zero.

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

from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ
from image_segmenter_tpu_torch.utils.backend import resolve_device

ROUNDS = 5
BASELINE_MP_S = 50.0          # BASELINE.md's target, MP/s a chip
H2D_MB = 24
H2D_TRIES = 4
CONTENT = "synthetic"
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
            rounds: int = ROUNDS, tag: str = "") -> dict:
    """Cold call, warm counted call, streaming and device-resident rounds
    of `pipe` (of `model`) on `imgs`: the record without the run's
    `h2d_gbs` and `card`."""
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
    return {
        "metric": f"pipeline_{model}_matting_kmeans16_{h}x{w}_b{b}",
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
        "content": CONTENT,
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
            "secondary": env.get("BENCH_SECONDARY", "isnet-general-use")}


def main(argv=None, device="cuda") -> int:
    argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.bench",
        description="The main path's MP/s; set BENCH_H, BENCH_W, "
                    "BENCH_BATCH, BENCH_REPS, BENCH_MODEL, BENCH_SECONDARY."
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
        imgs = synthetic_batch(cfg["batch"], cfg["h"], cfg["w"])
        pipe = Pipeline(model=cfg["model"], k=16, device=dev)
        rec = measure(pipe, cfg["model"], imgs, cfg["reps"])
        del pipe
        h2d_post = h2d_gbs(dev)
        log(f"host-to-device (after the runs): {h2d_post} GB/s")
        rec["h2d_gbs"] = {"pre": h2d_pre, "post": h2d_post}
        rec["card"] = card
        rec = {k: rec[k] for k in FIELDS}
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
