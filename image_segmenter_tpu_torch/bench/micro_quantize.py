"""Microbench: the palette map on the interleaved frame (K4) against the
same map on flat planes (K7).

Counterpart of the repo's bench/micro_quantize.py, which held the JAX
package's flat (N/128, 128) planar blocking against its native (H, W)
blocks on the TPU. Here: K4 (`kernels.quantize.quantize_map`) reads the
(B, H, W, 3) frame as it lies; K7 (`kernels.quantize_flat`) reads three
colour planes and an alpha plane. K7 is timed twice: the kernel alone on
planes that already exist, and the whole function with the split of the
frame into planes and the stack back, the layout cost the study is about.
The outputs must be bit-equal. The TPU bench's count of relayout copies in
the compiled HLO has no counterpart and is dropped.

Inputs follow the TPU bench: numpy's default_rng(5), uniform colours, 80 %
opaque alpha, one random 16-colour palette for every image, brightness
threshold 40. On a CPU tensor each wrapper takes its plain version, so a
CPU run checks the plumbing only and its times are the host's.

    python -m image_segmenter_tpu_torch.bench.micro_quantize [cuda|cpu] [H W B]
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from image_segmenter_tpu_torch.kernels import quantize as K4
from image_segmenter_tpu_torch.kernels import quantize_flat as K7
from image_segmenter_tpu_torch.utils.backend import resolve_device

K, THRESHOLD = 16, 40.0


def setup(device, b: int, h: int, w: int, seed: int = 5):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rgb = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), np.uint8)).to(dev)
    alpha = torch.from_numpy(
        (rng.random((b, h, w)) > 0.2).astype(np.uint8) * 255).to(dev)
    cent = rng.integers(0, 256, (K, 3)).astype(np.float32)
    centers = torch.from_numpy(cent).to(dev)[None].repeat(b, 1, 1)
    thr = torch.full((b,), THRESHOLD, dtype=torch.float32, device=dev)
    return rgb, alpha, centers, thr


def median_ms(fn, on_card: bool, reps: int) -> float:
    """Median of `reps` warm runs: CUDA events on the card, else the host
    clock."""
    fn()
    times = []
    for _ in range(reps):
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device="cuda", b: int = 4, h: int = 2160, w: int = 3840,
        reps: int = 10) -> dict:
    """{"k4_ms", "k7_kernel_ms", "k7_function_ms", "split_ms", "stack_ms",
    "equal", "k4_launches", "k7_launches"}: times are medians of `reps`;
    `equal` says whether K7's output has K4's bytes."""
    rgb, alpha, centers, thr = setup(device, b, h, w)
    on_card = rgb.is_cuda
    n4, n7 = K4.LAUNCHES, K7.LAUNCHES
    out4 = K4.quantize_map(rgb, alpha, centers, K, thr)
    out7 = K7.quantize_map_flat(rgb, alpha, centers, K, thr)
    planes = K7.split_planes(rgb)
    alpha_flat = alpha.reshape(b, h * w)
    out_planes = K7.quantize_planes(planes, alpha_flat, centers, K, thr)
    equal = bool(torch.equal(out4, out7)
                 and torch.equal(K7.stack_planes(out_planes, h, w), out4))
    res = {
        "k4_ms": median_ms(
            lambda: K4.quantize_map(rgb, alpha, centers, K, thr),
            on_card, reps),
        "k7_kernel_ms": median_ms(
            lambda: K7.quantize_planes(planes, alpha_flat, centers, K, thr),
            on_card, reps),
        "k7_function_ms": median_ms(
            lambda: K7.quantize_map_flat(rgb, alpha, centers, K, thr),
            on_card, reps),
        "split_ms": median_ms(lambda: K7.split_planes(rgb), on_card, reps),
        "stack_ms": median_ms(lambda: K7.stack_planes(out_planes, h, w),
                              on_card, reps),
        "equal": equal,
    }
    res["k4_launches"] = K4.LAUNCHES - n4
    res["k7_launches"] = K7.LAUNCHES - n7
    return res


def main(argv) -> None:
    device = argv[1] if len(argv) > 1 else "cuda"
    h, w, b = (int(v) for v in argv[2:5]) if len(argv) > 4 else (2160, 3840, 4)
    res = run(device, b, h, w)
    for key, val in res.items():
        print(f"[micro_quantize] {key}: {val}", flush=True)
    if not res["equal"]:
        raise SystemExit("K7's output differs from K4's")


if __name__ == "__main__":
    main(sys.argv)
