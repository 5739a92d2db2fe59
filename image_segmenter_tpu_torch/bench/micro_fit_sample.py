"""The colour sample and the k-means fit at the pipeline's shapes.

    python -m image_segmenter_tpu_torch.bench.micro_fit_sample \
        [--b 4] [--h 2160] [--w 3840] [--points 16384] [--reps 5]

Counterpart of the JAX package's bench/micro_fit_sample.py, at its shapes:

- the colour sample: on a batch of b frames of bench.py's synthetic image,
  each image's pixels at stride 2 and 4 packed to u32 keys and reduced to
  16,384 weighted samples (`ops/unique.sorted_weighted_sample`: a sort of
  every key, then every stride-th), one image after another;
- the fit: `solvers/kmeans.kmeans_fit` on b sets of 16,384 uniform integer
  colours with uniform weights, k 16, seed 42, one set after another: at
  n_init 2, n_init 1, and n_init 2 with max_iter 30.

Times from synchronised calls (the median of `--reps` after one warm
call); the sample also from a CUDA graph (the fit reads the device from
the host every iteration). One JSON line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.bench import synthetic_batch
from image_segmenter_tpu_torch.bench.micro_common import REPS, emit, \
    graph_ms, sync_ms
from image_segmenter_tpu_torch.ops.color import pack_rgb_u32
from image_segmenter_tpu_torch.ops.unique import sorted_weighted_sample
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils.backend import resolve_device

CAP = 1 << 14
K = 16
FITS = {"n_init_2": {"n_init": 2}, "n_init_1": {"n_init": 1},
        "n_init_2_max_iter_30": {"n_init": 2, "max_iter": 30}}


def sample(imgs: torch.Tensor, stride: int) -> list:
    """Each image's weighted sample of its stride-subsampled colours."""
    out = []
    for rgb in imgs:
        packed = pack_rgb_u32(rgb[::stride, ::stride].reshape(-1, 3))
        fit = torch.ones(packed.shape, dtype=torch.bool, device=rgb.device)
        out.append(sorted_weighted_sample(packed, fit, cap=CAP))
    return out


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.micro_fit_sample")
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--h", type=int, default=2160)
    ap.add_argument("--w", type=int, default=3840)
    ap.add_argument("--points", type=int, default=CAP)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    imgs = torch.from_numpy(synthetic_batch(args.b, args.h, args.w)).to(dev)
    rows = {}
    for stride in (2, 4):
        def fn(stride=stride):
            return sample(imgs, stride)
        keys = -(-args.h // stride) * -(-args.w // stride)
        rows[f"sample_stride_{stride}"] = {
            "keys_per_image": keys, **sync_ms(fn, dev, args.reps),
            "graph_ms": (graph_ms(fn, launches=1, reps=args.reps)
                         if dev.type == "cuda" else None)}
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.integers(
        0, 255, (args.b, args.points, 3)).astype(np.float32)).to(dev)
    wts = torch.from_numpy(rng.random((args.b, args.points)).astype(
        np.float32)).to(dev)
    for name, kw in FITS.items():
        def fit(kw=kw):
            return [KM.kmeans_fit(vals[i], wts[i], K, seed=42, **kw).centers
                    for i in range(args.b)]
        rows[f"fit_{name}"] = sync_ms(fit, dev, args.reps)
    emit("fit_sample", dev, {
        "shapes": {"batch": [args.b, args.h, args.w, 3], "cap": CAP,
                   "fit_points": [args.b, args.points, 3], "k": K},
        "reps": args.reps, "timing": "median of synchronised calls, host "
        "clock; graph_ms from a CUDA graph replay", "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
