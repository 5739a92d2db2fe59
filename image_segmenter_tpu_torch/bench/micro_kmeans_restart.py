"""Sequential against lock-step restarts of the seeded k-means fit.

    python -m image_segmenter_tpu_torch.bench.micro_kmeans_restart \
        [--points N] [--compat-points N] [--reps R]

Counterpart of the JAX package's bench/micro_kmeans_restart.py, at its
shapes: `solvers/kmeans.kmeans_fit` with `batch_restarts` False and True

- at the pipeline's shape: 4 images of 16,384 points (uniform integer
  colours, weights 1 on 90 % of them), k 16, n_init 2, one image after
  another (the port's fit takes one point set; JAX vmaps the four);
- `kmeans_fit_det` on the same batch of four, the fit the pipeline ships;
- at the compat shape: 2^20 points, k 16, n_init 10.

Times from synchronised calls, the median of `--reps` (5) after one warm
call; no CUDA graph: every Lloyd iteration reads two flags on the host.
The two restart orders must give the same centres, bit for bit. One JSON
line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.micro_common import REPS, emit, sync_ms
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils.backend import resolve_device

B, K, N_PIPELINE, N_COMPAT = 4, 16, 1 << 14, 1 << 20


def inputs(b: int, n: int, dev, seed: int = 0):
    """(b, n, 3) float32 integer colours and (b, n) weights, 1 on about
    90 % of the points."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.integers(0, 256, (b, n, 3)).astype(np.float32))
    w = torch.from_numpy((rng.random((b, n)) > 0.1).astype(np.float32))
    return pts.to(dev), w.to(dev)


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.micro_kmeans_restart")
    ap.add_argument("--points", type=int, default=N_PIPELINE)
    ap.add_argument("--compat-points", type=int, default=N_COMPAT)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    pts, w = inputs(B, args.points, dev)
    rows, centers = {}, {}
    for br in (False, True):
        def fit(br=br):
            centers[("pipeline", br)] = torch.stack(
                [KM.kmeans_fit(pts[i], w[i], K, n_init=2,
                               batch_restarts=br).centers for i in range(B)])
        rows[f"pipeline_r2_batch_restarts_{br}"] = sync_ms(fit, dev,
                                                           args.reps)
    rows["pipeline_det"] = sync_ms(lambda: KM.kmeans_fit_det(pts, w, K), dev,
                                   args.reps)
    pts1, w1 = inputs(1, args.compat_points, dev, seed=1)
    w1 = torch.ones_like(w1)
    for br in (False, True):
        def fit1(br=br):
            centers[("compat", br)] = KM.kmeans_fit(
                pts1[0], w1[0], K, n_init=10, batch_restarts=br).centers
        rows[f"compat_r10_batch_restarts_{br}"] = sync_ms(fit1, dev,
                                                          args.reps)
    same = all(torch.equal(centers[(s, False)], centers[(s, True)])
               for s in ("pipeline", "compat"))
    emit("kmeans_restart", dev, {
        "shapes": {"pipeline": [B, args.points, 3], "compat":
                   [args.compat_points, 3], "k": K},
        "reps": args.reps, "timing": "median of synchronised calls, host "
        "clock", "restart_orders_bit_equal": same, "rows": rows})
    if not same:
        raise SystemExit("micro_kmeans_restart: the restart orders differ")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
