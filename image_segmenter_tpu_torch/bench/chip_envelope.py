"""The card's measured envelope: GEMM TFLOP/s in bf16 and float32, and
the memory's copy rate, beside the data sheet's figures.

    python -m image_segmenter_tpu_torch.bench.chip_envelope \
        [--n 2048] [--k 32] [--mb 512] [--copies 16] [--reps 5]

Counterpart of the JAX package's bench/chip_envelope.py. Independent
operations in one timed window, as its protocol: k products of two
different n x n matrices (bf16 with float32 accumulation on the tensor
cores; float32 with TF32 off, as the port runs, so outside the tensor
cores), and `copies` copies of different `mb` MiB buffers (each reads and
writes its bytes once). A window is timed between two CUDA events; the
median of `--reps` windows after one warm window (`micro_quantize.
median_ms`; on the CPU the host clock times it). Reported beside the
kernel table's divisors (3.35 TB/s, 67 TFLOP/s float32) and the data
sheet's bf16 tensor rate; no bound changes with them. One JSON line.
"""

from __future__ import annotations

import argparse
import sys

import torch

from image_segmenter_tpu_torch.bench.micro_common import DATASHEET, REPS, emit
from image_segmenter_tpu_torch.bench.micro_quantize import median_ms
from image_segmenter_tpu_torch.utils.backend import resolve_device, \
    strict_f32


def measure(dev: torch.device, n: int = 2048, k: int = 32, mb: int = 512,
            copies: int = 16, reps: int = REPS) -> dict:
    """{"matmul_bf16_tflops", "matmul_f32_tflops", "copy_gbs"} and the
    windows' ms."""
    strict_f32()
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        a = torch.randn((k, n, n), generator=g, device=dev).to(dt)
        b = torch.randn((k, n, n), generator=g, device=dev).to(dt)
        c = torch.empty((n, n), device=dev, dtype=dt)

        def products(a=a, b=b, c=c):
            for i in range(k):
                torch.mm(a[i], b[i], out=c)
        ms = median_ms(products, dev.type == "cuda", reps)
        out[f"matmul_{name}_ms"] = ms
        out[f"matmul_{name}_tflops"] = 2 * k * n ** 3 / (ms * 1e-3) / 1e12
        del a, b, c
    n_el = mb * (1 << 20) // 4
    src = torch.rand((copies, n_el), generator=g, device=dev)
    dst = torch.empty_like(src)

    def copy():
        for i in range(copies):
            dst[i].copy_(src[i])
    ms = median_ms(copy, dev.type == "cuda", reps)
    out["copy_ms"] = ms
    out["copy_gbs"] = 2 * copies * n_el * 4 / (ms * 1e-3) / 1e9
    return out


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.chip_envelope")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--mb", type=int, default=512)
    ap.add_argument("--copies", type=int, default=16)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    m = measure(dev, args.n, args.k, args.mb, args.copies, args.reps)
    emit("chip_envelope", dev, {
        "shape": {"matmul": [args.k, args.n, args.n, args.n],
                  "copy": [args.copies, args.mb]},
        "reps": args.reps, "timing": "median of windows between two CUDA "
        "events (host clock on the CPU)", **m,
        "datasheet": DATASHEET,
        # the card's shares of its data sheet; a CPU run has none
        "share_of_datasheet": None if dev.type != "cuda" else {
            "bf16": m["matmul_bf16_tflops"] / DATASHEET["bf16_tflops"],
            "f32": m["matmul_f32_tflops"] / DATASHEET["f32_tflops"],
            "copy": m["copy_gbs"] / DATASHEET["hbm_gbs"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
