"""The operations a BiRefNet call needs, and the bound of each deformable
convolution, from their shapes.

Each count is of what the algorithm needs for these inputs, each
operation once (2 x the multiply-adds), not of what a kernel happens to
execute:

- the network (`network_flops`): every matrix product and convolution of
  one forward of the reference's network (`reference/birefnet_plain.py`)
  at the configuration's widths and input size, counted from its
  operations on the meta device (shapes only): the Swin-L backbone at
  the input and at half of it (a windowed block's qkv and proj on its
  grid padded to a multiple of the window, since the padded tokens are
  queries and keys like any other, its MLP on the grid itself; Q K^T and
  A V of every window), the squeeze block and the decoder (each
  deformable convolution's product with its weight over its k^2 taps,
  and its offset and modulator convolutions). The softmax, LayerNorms,
  GELU, resizes, the bilinear sampling and the elementwise work are not
  counted. All of it is bfloat16 in the program but conv_out1, float32
  (`conv_out1_flops`).
- a deformable convolution (`deform_flops`, `deform_bytes`): 2 B H W 64
  256 k^2 operations; its input (bfloat16), offsets and modulators
  (float32), weight (bfloat16) and output (bfloat16) each read or
  written once. `deform_launches` lists a call's 20: the squeeze block
  and decoder blocks 4 to 1 at 1/32, 1/32, 1/16, 1/8 and 1/4 of the
  input, each with branches of kernels 1, 1, 3 and 7.
- `call_flops`: a `pipeline_run_birefnet` call, {"bf16": the network,
  "f32": conv_out1 and the stages after the mask}, the latter by
  `flops.py`'s constants, as `flops.call_flops` counts them.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference import birefnet_plain as BP
from benchmark.yardstick import flops
from benchmark.yardstick.peaks import PEAK_FLOPS, PEAK_HBM_BYTES_S
from benchmark.yardstick.sam_flops import MatmulCount

IN_CHANNELS, OUT_CHANNELS = BP.INTER, BP.BRANCH
BRANCH_KERNELS = (1, 1, 3, 7)
SCALES = (32, 32, 16, 8, 4)  # the squeeze block, decoder blocks 4 to 1


@functools.lru_cache(maxsize=8)
def _one_frame(widths: tuple, size: tuple) -> int:
    with torch.device("meta"):
        net = BP.BiRefNetPlain(**dict(widths))
        x = torch.empty((1, 3, *size))
    with torch.no_grad(), MatmulCount() as count:
        net(x)
    return count.flops


def conv_out1_flops(w: dict, size, frames: int) -> int:
    """conv_out1, a 1 x 1 convolution to one channel at the input's size
    over the decoder's output and the input's own branch."""
    c = w["embed_dim"]
    return 2 * frames * size[0] * size[1] * (c + c // 4)


def network_flops(w: dict, size, frames: int) -> int:
    """The network's FLOPs on `frames` frames of `size` at widths `w`
    (`birefnet_plain.widths` keys), conv_out1 included."""
    key = tuple(sorted(BP.widths(**w).items()))
    return _one_frame(key, tuple(size)) * frames


def deform_launches(size, frames: int) -> list:
    """(B, H, W, k) of a call's deformable convolutions, in order."""
    return [(frames, size[0] // s, size[1] // s, k)
            for s in SCALES for k in BRANCH_KERNELS]


def deform_flops(b: int, h: int, w: int, k: int) -> int:
    return 2 * b * h * w * IN_CHANNELS * OUT_CHANNELS * k * k


def deform_bytes(b: int, h: int, w: int, k: int) -> int:
    px = b * h * w
    return (px * IN_CHANNELS * 2 + px * 3 * k * k * 4
            + OUT_CHANNELS * IN_CHANNELS * k * k * 2 + px * OUT_CHANNELS * 2)


def deform_bound_s(b: int, h: int, w: int, k: int) -> float:
    """The least time of one launch: its operations at the bf16 peak or
    its bytes at the memory's, whichever is larger."""
    return max(deform_flops(b, h, w, k) / PEAK_FLOPS["bf16"],
               deform_bytes(b, h, w, k) / PEAK_HBM_BYTES_S)


def call_flops(cfg: dict, frames: int, matting_hw, pixels: int,
               matvecs: float, lloyd_iters: float) -> dict:
    """{"bf16": ..., "f32": ...} FLOPs of one call (see `flops.call_flops`
    for the arguments)."""
    w = BP.widths(**cfg["widths"])
    size = cfg["input_size"]
    net = network_flops(w, size, frames)
    out1 = conv_out1_flops(w, size, frames)
    mpx = frames * matting_hw[0] * matting_hw[1]
    k = cfg["k"]
    f32 = (out1 + mpx * flops.PRECOMPUTE_FLOPS
           + matvecs * mpx * flops.MATVEC_FLOPS
           + max(matvecs - 1, 0) * mpx * flops.CG_UPDATE_FLOPS
           + lloyd_iters * flops.SAMPLE * k * flops.KMEANS_FLOPS
           + frames * (k - 1) * flops.CANDIDATES * flops.SAMPLE
           * flops.SEED_FLOPS
           + pixels * (k * flops.MAP_FLOPS + 3))
    return {"bf16": net - out1, "f32": f32}
