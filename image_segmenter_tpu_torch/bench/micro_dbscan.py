"""DBSCAN at the adaptive_distance working shape.

    python -m image_segmenter_tpu_torch.bench.micro_dbscan \
        [--n 64717] [--buckets 65536] [--reps 5]

Counterpart of the JAX package's bench/micro_dbscan.py, at its shape:
`solvers/dbscan.dbscan_labels` on 64,717 points drawn from a standard
normal cloud in three dimensions (numpy's default_rng(0)), padded to
65,536 buckets, multiplicities uniform in [1, 2000), eps 0.125 (the
default similarity threshold 25 in adaptive_distance's normalised LAB),
min_samples 3. Times from synchronised calls (the median of `--reps`
after one warm call; no CUDA graph: the label propagation reads its
fixpoint on the host), with the cluster and noise counts. One JSON line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.micro_common import REPS, emit, sync_ms
from image_segmenter_tpu_torch.solvers.dbscan import dbscan_labels
from image_segmenter_tpu_torch.utils.backend import resolve_device

EPS, MIN_SAMPLES = 0.125, 3.0


def cloud(n: int, buckets: int, dev):
    """(points, counts, valid) of the JAX micro's cloud."""
    rng = np.random.default_rng(0)
    pts = np.zeros((buckets, 3), np.float32)
    pts[:n] = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    cnt = np.zeros(buckets, np.float32)
    cnt[:n] = rng.integers(1, 2000, n)
    valid = np.zeros(buckets, bool)
    valid[:n] = True
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(cnt).to(dev),
            torch.from_numpy(valid).to(dev))


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.micro_dbscan")
    ap.add_argument("--n", type=int, default=64717)
    ap.add_argument("--buckets", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    pts, cnt, valid = cloud(args.n, args.buckets, dev)
    out = {}

    def fn():
        out["labels"] = dbscan_labels(pts, cnt, valid, EPS, MIN_SAMPLES)
    t = sync_ms(fn, dev, args.reps)
    lbl = out["labels"].cpu().numpy()[:args.n]
    emit("dbscan", dev, {
        "shape": {"points": args.n, "buckets": args.buckets, "eps": EPS,
                  "min_samples": MIN_SAMPLES},
        "reps": args.reps, "timing": "median of synchronised calls, host "
        "clock", **t, "clusters": int(len(np.unique(lbl[lbl >= 0]))),
        "noise": int((lbl == -1).sum())})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
