"""Where hsv_clustering's k-means fit goes: the whole fit, one Lloyd
iteration on its own, and the bytes a fused pass would need.

    python -m image_segmenter_tpu_torch.bench.micro_hsv_fit \
        [--h 2160] [--w 3840] [--reps 5]

Counterpart of the JAX package's bench/micro_hsv_fit.py, at its shape:
bench.py's synthetic image at 2160 x 3840, its pixels as weighted
OpenCV-convention HSV (hsv_clustering's normalisation, weight 1 where
V > 30), k 16, n_init 10.

1. The fit as hsv_clustering runs it (`solvers/kmeans.kmeans_fit`, the
   ten restarts in lock step), synchronised calls; and the same fit with
   its `RestartLoop` stepped to its end (`utils.loops.Loop.run`), the
   branchless reseed a compiled program runs, which ranks the farthest
   points every iteration where `RestartLoop.run` ranks them only when a
   cluster is empty. Both must give the same centres.
2. One lock-step Lloyd iteration on its own, from ten fixed random sets
   of centres (`RestartLoop`'s assignment and sums over every block of
   points, then the centre update), synchronised calls and a CUDA graph;
   the whole fit's time over it is the number of iterations it implies.
3. The bytes that iteration's operations read and write, counted from
   their shapes (`micro_common.op_counts`), against what one fused pass
   must read: the points and their weights, once.
Both times are set beside the data sheet's memory rate. One JSON line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.bench import synthetic_batch
from image_segmenter_tpu_torch.bench.micro_common import DATASHEET, REPS, \
    emit, graph_ms, op_counts, sync_ms
from image_segmenter_tpu_torch.compat.color_simplify import _hsv_normalized
from image_segmenter_tpu_torch.ops.color import rgb_u8_to_hsv_cv
from image_segmenter_tpu_torch.ops.scan import tree_sum
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils.backend import resolve_device
from image_segmenter_tpu_torch.utils.loops import Loop

K, R = 16, 10


def hsv_points(h: int, w: int, dev):
    """hsv_clustering's points and weights of bench.py's image."""
    rgb = torch.from_numpy(synthetic_batch(1, h, w)[0]).to(dev).reshape(-1, 3)
    hsv = rgb_u8_to_hsv_cv(rgb)
    return _hsv_normalized(hsv), (hsv[..., 2] > 30).to(torch.float32)


def one_iteration(ptsT: torch.Tensor, w: torch.Tensor, call: torch.Tensor):
    """One Lloyd step of every restart, as `RestartLoop` takes it:
    ptsT (nb, 3, block), w (nb, block), call (R, k, 3) -> the new centres
    and each restart's inertia."""
    nb = ptsT.shape[0]
    r, k, d = call.shape
    bins = torch.arange(k, device=call.device)[None, :, None]
    sums = torch.zeros((r, k, d), dtype=torch.float32, device=call.device)
    counts = torch.zeros((r, k), dtype=torch.float32, device=call.device)
    inertia = torch.zeros((r,), dtype=torch.float32, device=call.device)
    for j in range(nb):
        d2 = KM._d2_points_last(ptsT[j], call)
        dmin, lbl = torch.min(d2, dim=1)
        onehot = (lbl[:, None, :] == bins).to(torch.float32) * w[j]
        sums = sums + tree_sum(onehot[:, :, None, :] * ptsT[j])
        counts = counts + tree_sum(onehot)
        inertia = inertia + tree_sum(dmin * w[j])
    new = torch.where(counts[..., None] > 0,
                      sums / torch.clamp_min(counts, 1.0)[..., None], call)
    return new, inertia


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.micro_hsv_fit")
    ap.add_argument("--h", type=int, default=2160)
    ap.add_argument("--w", type=int, default=3840)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    pts, wts = hsv_points(args.h, args.w, dev)
    full = sync_ms(lambda: KM.kmeans_fit(pts, wts, K, n_init=R).centers,
                   dev, args.reps)

    def branchless_fit():
        prog = KM.kmeans_fit_program(pts, wts, K, n_init=R)
        Loop.run(next(prog))  # the ten restarts' one loop
        try:
            prog.send(None)
        except StopIteration as stop:
            return stop.value.centers
    branchless = sync_ms(branchless_fit, dev, args.reps)
    same = torch.equal(branchless_fit(),
                       KM.kmeans_fit(pts, wts, K, n_init=R).centers)

    padded, pw = KM._pad_points(pts[None], wts[None])
    ptsT = padded[0].transpose(1, 2).contiguous()
    w = pw[0]
    call = torch.from_numpy(np.random.default_rng(1).random(
        (R, K, 3)).astype(np.float32)).to(dev)

    def step():
        return one_iteration(ptsT, w, call)
    it = sync_ms(step, dev, args.reps)
    it["graph_ms"] = (graph_ms(step, launches=1, reps=args.reps)
                      if dev.type == "cuda" else None)
    counts = op_counts(step)
    moved = counts["bytes_read"] + counts["bytes_written"]
    fused = (ptsT.numel() + w.numel()) * 4
    t_iter = it["graph_ms"] or it["ms"]
    emit("hsv_fit", dev, {
        "shape": {"points": int(pts.shape[0]), "padded": int(w.numel()),
                  "k": K, "n_init": R},
        "reps": args.reps, "timing": "median of synchronised calls, host "
        "clock; graph_ms from a CUDA graph replay",
        "fit": full, "fit_branchless": branchless,
        "branchless_over_fit": branchless["ms"] / full["ms"],
        "same_centres": same, "one_iteration": it,
        "implied_iterations": full["ms"] / t_iter,
        "one_iteration_ops": counts["ops"],
        "one_iteration_bytes": moved,
        "fused_pass_bytes": fused,
        "bytes_over_fused": moved / fused,
        "one_iteration_gbs": moved / (t_iter * 1e-3) / 1e9,
        "fused_floor_ms": fused / (DATASHEET["hbm_gbs"] * 1e9) * 1e3,
        "datasheet_hbm_gbs": DATASHEET["hbm_gbs"]})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
