"""The operations and bytes a `pipeline_run` call needs, from its shapes.

Each count is of what the algorithm needs for these inputs, each
operation once, not of what a kernel happens to execute:

- The CNN: 2 x the multiply-adds of every convolution, counted from the
  layer shapes of one forward of the reference's network at the
  configuration's input size (a copy of the port's `bench/
  micro_u2netp_pack` arithmetic: 2 x output elements x input channels x
  kernel taps), split by the precision each runs at in the program.
- The matting, float32, at the matting shape (B, h, w):
  `MATVEC_FLOPS` a pixel for each (L + lam C) q, counted from the
  operations of the plain formula (`reference/plain.laplacian_matvec`:
  box sum 4, mean 1, centred covariance 81, its mean 3, the packed LDL
  solve 17, the window offset 6, the two member box sums 16, the pixel's
  sum 8; then lam C q 3); `CG_UPDATE_FLOPS` a pixel for each iteration's
  vector updates and dot products; `PRECOMPUTE_FLOPS` a pixel once, the
  window factors (the port's K2 docstring counts about 690 unfused
  operations a pixel).
- The k-means on its grid sample of `SAMPLE` colours: `KMEANS_FLOPS` a
  point and centre for each Lloyd iteration (a distance 8, the
  accumulation 6), and the seeding's (k - 1) x `CANDIDATES` distances of
  10 a point.
- The palette map: `MAP_FLOPS` a pixel and palette entry (3 differences,
  3 squares, 2 sums), and 3 for the brightness.
- K3's bytes: each input read once and the output written once, 15
  float32 planes a pixel: 10 of K2's 12 planes (the LDL factors, n and
  the means), the image's 3, p and the result.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import nets

MATVEC_FLOPS = 139
CG_UPDATE_FLOPS = 16
PRECOMPUTE_FLOPS = 690
KMEANS_FLOPS = 14
SEED_FLOPS = 10
CANDIDATES = 8
SAMPLE = 1 << 14
MAP_FLOPS = 8
K3_PLANES = 15


class _ConvCount(TorchDispatchMode):
    """2 x the multiply-adds of every convolution dispatched, by the type
    of its input (micro_common's `_flops`)."""

    def __init__(self):
        super().__init__()
        self.flops = {"bf16": 0, "f32": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] == "convolution":
            kind = "bf16" if args[0].dtype == torch.bfloat16 else "f32"
            self.flops[kind] += 2 * out.numel() * math.prod(args[1].shape[1:])
        return out


def cnn_flops(arch: str, input_size, batch: int) -> dict:
    """{"bf16": ..., "f32": ...} FLOPs of one forward of `batch` images,
    from one forward on the meta device (shapes only) of the network at
    the program's arithmetic: the REBNCONVs and ISNet's conv_in on
    bfloat16 operands (the control's path has those types), the side and
    fuse convolutions in float32."""
    net = nets.build(arch, "fp8")
    x = torch.empty((batch, 3, *input_size), device="meta")
    with torch.no_grad(), _ConvCount() as count:
        net(x)
    return count.flops


def call_flops(cfg: dict, frames: int, matting_hw, pixels: int,
               matvecs: float, lloyd_iters: float) -> dict:
    """{"bf16": ..., "f32": ...} FLOPs of one call: `frames` images of
    `pixels` pixels in all, matting at `matting_hw`, `matvecs` K3 launches
    and `lloyd_iters` Lloyd iterations summed over the frames."""
    cnn = cnn_flops(cfg["arch"], cfg["input_size"], frames)
    mpx = frames * matting_hw[0] * matting_hw[1]
    k = cfg["k"]
    f32 = (cnn["f32"] + mpx * PRECOMPUTE_FLOPS
           + matvecs * mpx * MATVEC_FLOPS
           + max(matvecs - 1, 0) * mpx * CG_UPDATE_FLOPS
           + lloyd_iters * SAMPLE * k * KMEANS_FLOPS
           + frames * (k - 1) * CANDIDATES * SAMPLE * SEED_FLOPS
           + pixels * (k * MAP_FLOPS + 3))
    return {"bf16": cnn["bf16"], "f32": f32}


def k3_bytes(matting_hw, frames: int) -> int:
    """Bytes one K3 launch needs at the matting shape."""
    return K3_PLANES * 4 * frames * matting_hw[0] * matting_hw[1]


def matting_hw(h: int, w: int, max_dim: int) -> tuple:
    """The matting shape of an (h, w) frame (the reference's shrink)."""
    if h <= max_dim and w <= max_dim:
        return h, w
    scale = min(max_dim / h, max_dim / w)
    return max(1, int(h * scale)), max(1, int(w * scale))
