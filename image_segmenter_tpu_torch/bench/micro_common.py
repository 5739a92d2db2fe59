"""What the attribution micros share: timing, counting and their line.

- `sync_ms`: one warm call, then `reps` calls each synchronised on its
  own, host clock: the median and the spread in ms.
- `graph_ms` (micro_precompute_hist's): the same calls captured into one
  CUDA graph and replayed, the device's time alone; only for calls that
  never read the device from the host.
- `op_counts`: the operations one call dispatches, with the bytes they
  read and write (each operation's inputs read once and its outputs
  written once, views excluded: what an unfused eager run moves) and the
  multiply-adds of its convolutions and matrix products as FLOPs, all
  counted from the tensors' shapes by a dispatch mode.
- `emit`: the micro's one JSON line, with the device and the card's name
  and power limit.

A micro runs on the card unless `main(argv, device="cpu")` asks for the
CPU, and raises without a card.
"""

from __future__ import annotations

import json
import math
import statistics

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from image_segmenter_tpu_torch.bench.bench import card_label, timed_calls
from image_segmenter_tpu_torch.bench.micro_precompute_hist import graph_ms

# NVIDIA's H100 SXM data sheet (dense, at 700 W), the kernel table's
# divisors: HBM3 and float32 outside the tensor cores; bf16 tensor cores
DATASHEET = {"hbm_gbs": 3350.0, "f32_tflops": 67.0, "bf16_tflops": 989.0}
REPS = 5

__all__ = ["DATASHEET", "REPS", "emit", "graph_ms", "op_counts", "sync_ms"]


def sync_ms(fn, dev: torch.device, reps: int = REPS) -> dict:
    """One warm call of fn(), then `reps` synchronised calls: {"ms" (the
    median), "min_ms", "max_ms"}."""
    times = [t * 1e3 for t in timed_calls(fn, dev, reps)[1]]
    return {"ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = self.read = self.written = 0
        self.flops = {"conv": 0, "matmul": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._schema.is_mutable or not getattr(func, "is_view", False):
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.ops += 1
            self.read += sum(t.numel() * t.element_size() for t in ins)
            self.written += sum(t.numel() * t.element_size() for t in outs)
            kind, flops = _flops(func, ins, outs)
            if kind:
                self.flops[kind] += flops
        return out


def _flops(func, ins, outs):
    """("conv" or "matmul", 2 x its multiply-adds), or (None, 0)."""
    name = func.__name__.split(".")[0]
    if name == "convolution" and len(ins) >= 2:
        return "conv", 2 * outs[0].numel() * math.prod(ins[1].shape[1:])
    if name in ("mm", "bmm", "addmm", "baddbmm") and outs:
        return "matmul", 2 * outs[0].numel() * ins[-2].shape[-1]
    return None, 0


def op_counts(fn) -> dict:
    """The operations one call of fn() dispatches: {"ops", "bytes_read",
    "bytes_written", "flops", "flops_by_kind"}."""
    with _Counter() as c:
        fn()
    return {"ops": c.ops, "bytes_read": c.read, "bytes_written": c.written,
            "flops": sum(c.flops.values()), "flops_by_kind": c.flops}


def emit(micro: str, dev: torch.device, fields: dict) -> dict:
    """Print the micro's one JSON line on stdout and return it."""
    rec = {"micro": micro, "device": str(dev), "card": card_label(dev),
           **fields}
    print(json.dumps(rec), flush=True)
    return rec
