"""K4: fused nearest-palette quantization with black-filter and alpha mask.

Replaces image_segmenter_tpu/kernels/pallas_quantize.py (`_kernel` via
`quantize_map`). Per pixel: the squared RGB distance
(r-c_r)^2 + (g-c_g)^2 + (b-c_b)^2 to each palette entry, the first
minimum (strict <) among the first k_real entries, and the winning colour
where alpha > 0 and brightness (r+g+b) * (1/3) > thr, else 0. The
brightness is a multiply by the float32 1/3, not a division: the two
round differently at sums such as r+g+b = 90 against thr = 30.

The CUDA kernel reads the interleaved (B, H, W, 3) frame directly; the
TPU kernel's split into planes was a layout cost of that chip.

What bounds K4 on the H100 is the instructions it executes, not the 7
bytes a pixel it moves: held bit for bit to a plain version that rounds
every step, a float palette allows no fused multiply-add, about 11
instructions a pixel and entry. But the main path's palettes are k-means
centres rounded to u8, and with u8 pixels and whole-number centres in
[0, 255] every intermediate is an integer below 2^24, exact in any order.
So each block of csrc/quantize.cu tests its image's palette as it stages
it (`whole_number_palette` is that test's twin) and takes one of two
paths: integer keys `((|c|^2 << 8) | k) - 512 (p . c)` from one `dp4a`
and one multiply-add, minimised (three instructions an entry; the minimum
is the nearest entry and, among equals, the lowest index), or the
separately rounded float32 arithmetic for any other palette. Both carry
the winner's index and look its colour up once. A thread takes 4 pixels
as whole words where H*W is a multiple of 4.

`quantize_map` routes by device: a CUDA tensor launches csrc/quantize.cu,
a CPU tensor takes `quantize_map_plain`. Both are bit-exact to the same
semantics.
"""

from __future__ import annotations

import numpy as np
import torch

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.backend import targets_cuda
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process (read by chip_smoke.py)
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

# float32(1/3): a product of two float32 values rounds the same whether the
# scalar op runs in float32 or in double
_THIRD = float(np.float32(1.0 / 3.0))


def whole_number_palette(centers_f32: torch.Tensor, k_real: int) -> torch.Tensor:
    """(B,) bool: the kernel's per-image test. True where each of the first
    k_real entries is a whole number in [0, 255], so that every distance to
    a u8 pixel is an integer below 2^24 and the integer path is exact."""
    c = centers_f32[:, :max(0, min(centers_f32.shape[1], int(k_real)))]
    ok = (c >= 0.0) & (c <= 255.0) & (c == torch.floor(c))
    return ok.flatten(1).all(dim=1)


def quantize_map(rgb_u8: torch.Tensor, alpha: torch.Tensor,
                 centers_f32: torch.Tensor, k_real: int,
                 brightness_thr: torch.Tensor) -> torch.Tensor:
    """rgb_u8 (B, H, W, 3) uint8, alpha (B, H, W) uint8 or bool (> 0 is
    opaque), centers_f32 (B, k_max, 3) float32 (rows >= k_real ignored),
    brightness_thr (B,) float32 (-1.0 for "no filter") -> (B, H, W, 3)
    uint8."""
    b, h, w, c = rgb_u8.shape
    if (c != 3 or rgb_u8.dtype != torch.uint8
            or alpha.shape != (b, h, w)
            or alpha.dtype not in (torch.uint8, torch.bool)
            or centers_f32.dim() != 3 or centers_f32.shape[0] != b
            or centers_f32.shape[2] != 3 or centers_f32.dtype != torch.float32
            or brightness_thr.shape != (b,)
            or brightness_thr.dtype != torch.float32):
        raise ValueError("quantize_map: bad operand shapes or dtypes: "
                         f"{tuple(rgb_u8.shape)} {rgb_u8.dtype}, "
                         f"{tuple(alpha.shape)} {alpha.dtype}, "
                         f"{tuple(centers_f32.shape)} {centers_f32.dtype}, "
                         f"{tuple(brightness_thr.shape)} "
                         f"{brightness_thr.dtype}")
    if not targets_cuda(rgb_u8):
        return quantize_map_plain(rgb_u8, alpha, centers_f32, k_real,
                                  brightness_thr)
    global LAUNCHES
    ops = (rgb_u8, alpha, centers_f32, brightness_thr)
    if not all(t.is_cuda and t.is_contiguous() for t in ops):
        raise ValueError("quantize_map: operands must be contiguous on the card")
    k_max = centers_f32.shape[1]
    out = torch.empty_like(rgb_u8)
    lib = _build.library()
    stream = torch.cuda.current_stream(rgb_u8.device).cuda_stream
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(rgb_u8.device):
        rc = lib.iseg_quantize(rgb_u8.data_ptr(), alpha.data_ptr(),
                               centers_f32.data_ptr(),
                               brightness_thr.data_ptr(), b, h * w, k_max,
                               int(k_real), out.data_ptr(), stream)
    _build.check(rc, "quantize")
    LAUNCHES += 1
    return out


def quantize_map_plain(rgb_u8: torch.Tensor, alpha: torch.Tensor,
                       centers_f32: torch.Tensor, k_real: int,
                       brightness_thr: torch.Tensor) -> torch.Tensor:
    """The plain version: the same per-pixel semantics in torch ops."""
    f = rgb_u8.to(torch.float32)
    r, g, bl = f[..., 0], f[..., 1], f[..., 2]
    best_d = torch.full_like(r, float("inf"))
    best = torch.zeros_like(f)
    for k in range(min(centers_f32.shape[1], int(k_real))):
        c = centers_f32[:, k]                                  # (B, 3)
        cr, cg, cb = (c[:, j, None, None] for j in range(3))
        dr, dg, db = r - cr, g - cg, bl - cb
        d = (dr * dr + dg * dg) + db * db
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best = torch.where(better[..., None], c[:, None, None, :], best)
    brightness = ((r + g) + bl) * _THIRD
    fit = (alpha.to(torch.int32) > 0) & (brightness > brightness_thr[:, None, None])
    out = torch.where(fit[..., None], best, 0.0)
    return out.to(torch.int32).to(torch.uint8)
