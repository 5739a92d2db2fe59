"""Segment Anything's image encoder against its roofline, in %: the
encoder's FLOPs a call (`yardstick/sam_flops.encoder_flops`: the patch
embedding, every linear, Q K^T and A V, the relative-position einsums
and the neck, each once) over the bf16 peak (989 TFLOP/s), against the
encoder's device time a traced call.

The encoder is the only code of a prompted call that computes in
bfloat16, so a call's encoder runs from its first device operation whose
name says bfloat16 (the cast of the normalised input) to its last (the
neck's second convolution); its device time is the union of the
operations between, which all run in the network stage's graph, one
after another on one stream. The neck's last LayerNorm, float32 and tens
of microseconds, falls after it. A call is a `bench.pipeline.run` span of
the timeline. This module also holds what the readers of the encoder
share. None where the timeline holds no bfloat16 operation (a program
without a bfloat16 encoder)."""

import re

from benchmark.reference import sam_plain
from benchmark.yardstick import sam_flops
from benchmark.yardstick.peaks import PEAK_FLOPS
from benchmark.yardstick.timeline import busy_us

BENCH_SPAN = "bench.pipeline.run"
BF16 = re.compile(r"bf16|bfloat16", re.IGNORECASE)


def calls(run):
    """Per traced call, its device operations [(name, start_us, end_us)]
    in order of start; None without a timeline or a call span."""
    tl = run.get("timeline")
    if tl is None or not tl.device:
        return None
    spans = sorted((s, e) for name, s, e in tl.spans if name == BENCH_SPAN)
    if not spans:
        return None
    return [[op for op in tl.device if b0 <= op[1] <= b1]
            for b0, b1 in spans]


def encoder_ops(ops):
    """The operations of one call's encoder, or None where none says
    bfloat16."""
    idx = [i for i, (name, _, _) in enumerate(ops) if BF16.search(name)]
    return ops[idx[0]:idx[-1] + 1] if idx else None


def read(run):
    per_call = calls(run)
    if not per_call:
        return None
    times = []
    for ops in per_call:
        enc = encoder_ops(ops)
        if enc is None:
            return None
        times.append(busy_us([(s, e) for _, s, e in enc]) / 1e6)
    cfg = run["config"]
    w = sam_plain.widths(cfg["arch"], **cfg["widths"])
    least_s = sam_flops.encoder_flops(w, run["frames"]) / PEAK_FLOPS["bf16"]
    return 100.0 * least_s / (sum(times) / len(times))
