"""The operations a Segment Anything call needs, from its shapes.

Each count is of what the algorithm needs for these inputs, each
operation once (2 x the multiply-adds), not of what a kernel happens to
execute:

- the image encoder, at bfloat16 in the program (`encoder_flops`): the
  patch embedding; every linear on the tokens it runs on: in a windowed
  block the attention's qkv and proj on the grid padded to a multiple
  of the window (4,900 at ViT-H's 64 x 64 grid and window 14), since the
  padded tokens are queries and keys like any other, and the MLP's lin1
  and lin2 on the grid itself (4,096), cropped after the attention;
  Q K^T and A V at
  the true shapes, a window's tokens against its own in a windowed
  block, the whole grid in a global one; the two einsums of the
  decomposed relative-position bias (each query against a row, and
  against a column, of the table); the neck's 1 x 1 and 3 x 3
  convolutions. The softmax, the LayerNorms, GELU and the bias's
  broadcast add are not counted.
- the prompt encoder and the mask decoder, float32 (`decoder_flops`):
  every matrix product and (transposed) convolution of one forward of
  the reference's decoder at the configuration's widths, counted from
  its operations on the meta device (shapes only).
- `call_flops`: a `pipeline_run_prompted` call, {"bf16": the encoder,
  "f32": the decoder and the stages after the mask}, the latter by
  `flops.py`'s constants, as `flops.call_flops` counts them.

`tests/test_bench_sam.py` holds `encoder_flops` to a dispatch count of
the reference's encoder on the CPU.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import sam_plain
from benchmark.yardstick import flops

_MM = {"mm", "addmm", "bmm", "baddbmm"}


class MatmulCount(TorchDispatchMode):
    """2 x the multiply-adds of every matrix product and convolution
    dispatched (a transposed convolution counted from its input)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if name in _MM:
            a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") \
                else (args[0], args[1])
            self.flops += 2 * math.prod(a.shape) * b.shape[-1]
        elif name == "convolution":
            x, w, transposed = args[0], args[1], args[6]
            self.flops += 2 * (x.numel() * math.prod(w.shape[1:])
                               if transposed
                               else out.numel() * math.prod(w.shape[1:]))
        return out


def encoder_flops(w: dict, frames: int) -> int:
    """The image encoder's FLOPs on `frames` frames at widths `w`
    (`sam_plain.widths` keys)."""
    d, heads = w["embed_dim"], w["num_heads"]
    hd, mlp = d // heads, int(d * w["mlp_ratio"])
    g = w["img_size"] // w["patch_size"]
    ws = w["window_size"]
    gp = -(-g // ws) * ws
    macs = g * g * d * 3 * w["patch_size"] ** 2
    for i in range(w["depth"]):
        if i in w["global_attn_indexes"]:
            tokens, n, side = g * g, 1, g
        else:
            tokens, n, side = gp * gp, (gp // ws) ** 2, ws
        t = side * side
        macs += tokens * 4 * d * d + g * g * 2 * d * mlp
        macs += n * heads * 2 * t * t * hd        # Q K^T, A V
        macs += n * heads * 2 * t * side * hd     # rel_h, rel_w
    p = w["prompt_dim"]
    macs += g * g * (d * p + 9 * p * p)
    return 2 * macs * frames


def decoder_flops(arch: str, w: dict, frames: int) -> int:
    """The prompt encoder's and mask decoder's FLOPs on `frames` frames,
    one box each, counted on the meta device."""
    with torch.device("meta"):
        net = sam_plain.SamPlain(arch, **w)
        g = w["img_size"] // w["patch_size"]
        emb = torch.empty(1, w["prompt_dim"], g, g)
        box = torch.empty(1, 4)
    with torch.no_grad(), MatmulCount() as count:
        net.decode(emb, box)
    return count.flops * frames


def call_flops(cfg: dict, frames: int, matting_hw, pixels: int,
               matvecs: float, lloyd_iters: float) -> dict:
    """{"bf16": ..., "f32": ...} FLOPs of one call (see `flops.call_flops`
    for the arguments)."""
    w = sam_plain.widths(cfg["arch"], **cfg["widths"])
    mpx = frames * matting_hw[0] * matting_hw[1]
    k = cfg["k"]
    f32 = (decoder_flops(cfg["arch"], w, frames)
           + mpx * flops.PRECOMPUTE_FLOPS
           + matvecs * mpx * flops.MATVEC_FLOPS
           + max(matvecs - 1, 0) * mpx * flops.CG_UPDATE_FLOPS
           + lloyd_iters * flops.SAMPLE * k * flops.KMEANS_FLOPS
           + frames * (k - 1) * flops.CANDIDATES * flops.SAMPLE
           * flops.SEED_FLOPS
           + pixels * (k * flops.MAP_FLOPS + 3))
    return {"bf16": encoder_flops(w, frames), "f32": f32}
