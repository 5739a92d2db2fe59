"""The CNN stage's roofline: U^2-Netp's forward at 320 x 320, batch 4,
bf16, against the card's measured envelope.

    python -m image_segmenter_tpu_torch.bench.micro_u2netp_pack \
        [--b 4] [--size 320] [--reps 5]

Counterpart of the JAX package's bench/micro_u2netp_pack.py, without its
question: whether packing the batch into channels fills the TPU's matrix
unit is the MXU's, not the card's. What stays is the stage's roofline:

- FLOPs and bytes of one forward (`Session("u2netp", half=True).module` on
  a seeded normal input), counted from the shapes of the operations it
  dispatches (`micro_common.op_counts`: 2 x the convolutions' multiply-
  adds; each operation's inputs read and outputs written once, which is
  what the unfused forward moves);
- its time: synchronised calls, and a CUDA graph of the forward (the
  device's time alone), medians of `--reps`;
- the achieved TFLOP/s and GB/s as shares of the envelope measured in the
  same process (`chip_envelope.measure`: bf16 GEMMs and copies) and of the
  data sheet's rates.
One JSON line.
"""

from __future__ import annotations

import argparse
import sys

import torch

from image_segmenter_tpu_torch.bench import chip_envelope
from image_segmenter_tpu_torch.bench.micro_common import DATASHEET, REPS, \
    emit, graph_ms, op_counts, sync_ms
from image_segmenter_tpu_torch.models.registry import Session
from image_segmenter_tpu_torch.utils.backend import resolve_device


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.micro_u2netp_pack")
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    env = chip_envelope.measure(dev) if dev.type == "cuda" else None

    module = Session("u2netp", half=True, device=dev).module
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.b, 3, args.size, args.size), generator=g,
                    device=dev)

    @torch.no_grad()
    def forward():
        return module(x)[0]
    t = sync_ms(forward, dev, args.reps)
    t["graph_ms"] = (graph_ms(forward, launches=1, reps=args.reps)
                     if dev.type == "cuda" else None)
    with torch.no_grad():
        c = op_counts(forward)
    moved = c["bytes_read"] + c["bytes_written"]
    ms = t["graph_ms"] or t["ms"]
    tflops = c["flops"] / (ms * 1e-3) / 1e12
    gbs = moved / (ms * 1e-3) / 1e9
    rec = {"shape": [args.b, 3, args.size, args.size], "dtype": "bfloat16",
           "reps": args.reps, "timing": "median of synchronised calls, host "
           "clock; graph_ms from a CUDA graph replay", **t,
           "ops": c["ops"], "gflop_per_forward": c["flops"] / 1e9,
           "gflop_by_kind": {k: v / 1e9 for k, v in
                             c["flops_by_kind"].items()},
           "mb_moved_per_forward": moved / 1e6, "tflops": tflops,
           "gbs": gbs, "envelope": env, "share_of_datasheet": None,
           "share_of_envelope": None}
    if env is not None:  # the card's shares; a CPU run has none
        rec["share_of_datasheet"] = {
            "bf16": tflops / DATASHEET["bf16_tflops"],
            "hbm": gbs / DATASHEET["hbm_gbs"]}
        rec["share_of_envelope"] = {
            "bf16": tflops / env["matmul_bf16_tflops"],
            "copy": gbs / env["copy_gbs"]}
    emit("u2netp_pack", dev, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
