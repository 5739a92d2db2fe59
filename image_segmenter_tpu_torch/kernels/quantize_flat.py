"""K7: the palette map of K4 on four flat planes r, g, b, a.

Replaces the pallas_call inside `quantize_map_flat` of the repo's
bench/micro_quantize.py (the flat planar blocking of
pallas_quantize._kernel, kept there for a layout study). Same contract and
the same per-pixel arithmetic as `kernels/quantize.quantize_map` (K4), so
the two are bit-equal; what differs is the layout the kernel reads: three
contiguous colour planes and an alpha plane in, three planes out.

`quantize_planes` is the kernel alone, on planes; `quantize_map_flat` is
the whole function on the interleaved frame: split into planes, kernel,
stack back. The split and the stack are PyTorch copies, the layout cost
the study is about; the port's bench/micro_quantize.py times both.

Both route by device: a CUDA tensor launches csrc/quantize_flat.cu, a CPU
tensor takes the plain version.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels.quantize import _THIRD
from image_segmenter_tpu_torch.utils.backend import targets_cuda

LAUNCHES = 0  # kernel launches in this process (read by chip_smoke.py)


def split_planes(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (3, B, H*W) u8 contiguous planes (a copy)."""
    b, h, w, _ = rgb_u8.shape
    return rgb_u8.reshape(b, h * w, 3).permute(2, 0, 1).contiguous()


def stack_planes(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(3, B, H*W) u8 -> (B, H, W, 3) u8 contiguous (a copy)."""
    b = planes.shape[1]
    return planes.permute(1, 2, 0).reshape(b, h, w, 3).contiguous()


def _check(planes, alpha, centers_f32, brightness_thr) -> None:
    b = planes.shape[1] if planes.dim() == 3 else -1
    if (planes.dim() != 3 or planes.shape[0] != 3
            or planes.dtype != torch.uint8
            or alpha.shape != planes.shape[1:]
            or alpha.dtype not in (torch.uint8, torch.bool)
            or centers_f32.dim() != 3 or centers_f32.shape[0] != b
            or centers_f32.shape[2] != 3 or centers_f32.dtype != torch.float32
            or brightness_thr.shape != (b,)
            or brightness_thr.dtype != torch.float32):
        raise ValueError("quantize_planes: bad operand shapes or dtypes: "
                         f"{tuple(planes.shape)} {planes.dtype}, "
                         f"{tuple(alpha.shape)} {alpha.dtype}, "
                         f"{tuple(centers_f32.shape)} {centers_f32.dtype}, "
                         f"{tuple(brightness_thr.shape)} "
                         f"{brightness_thr.dtype}")


def quantize_planes(planes: torch.Tensor, alpha: torch.Tensor,
                    centers_f32: torch.Tensor, k_real: int,
                    brightness_thr: torch.Tensor) -> torch.Tensor:
    """planes (3, B, N) uint8 (r, g, b), alpha (B, N) uint8 or bool (> 0 is
    opaque), centers_f32 (B, k_max, 3) float32 (rows >= k_real ignored),
    brightness_thr (B,) float32 (-1.0 for "no filter") -> (3, B, N) uint8."""
    _check(planes, alpha, centers_f32, brightness_thr)
    if not targets_cuda(planes):
        return quantize_planes_plain(planes, alpha, centers_f32, k_real,
                                     brightness_thr)
    global LAUNCHES
    ops = (planes, alpha, centers_f32, brightness_thr)
    if not all(t.is_cuda and t.is_contiguous() for t in ops):
        raise ValueError("quantize_planes: operands must be contiguous on "
                         "the card")
    _, b, n = planes.shape
    out = torch.empty_like(planes)
    lib = _build.library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rc = lib.iseg_quantize_flat(planes.data_ptr(), alpha.data_ptr(),
                                centers_f32.data_ptr(),
                                brightness_thr.data_ptr(), b, n,
                                centers_f32.shape[1], int(k_real),
                                out.data_ptr(), stream)
    _build.check(rc, "quantize_flat")
    LAUNCHES += 1
    return out


def quantize_planes_plain(planes: torch.Tensor, alpha: torch.Tensor,
                          centers_f32: torch.Tensor, k_real: int,
                          brightness_thr: torch.Tensor) -> torch.Tensor:
    """The plain version: the kernel's per-pixel semantics in torch ops."""
    r, g, bl = planes.to(torch.float32)                        # each (B, N)
    best_d = torch.full_like(r, float("inf"))
    best = torch.zeros_like(planes, dtype=torch.float32)
    for k in range(min(centers_f32.shape[1], int(k_real))):
        c = centers_f32[:, k]                                  # (B, 3)
        dr, dg, db = r - c[:, 0:1], g - c[:, 1:2], bl - c[:, 2:3]
        d = (dr * dr + dg * dg) + db * db
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best = torch.where(better[None], c.t()[:, :, None], best)
    brightness = ((r + g) + bl) * _THIRD
    fit = (alpha.to(torch.int32) > 0) & (brightness > brightness_thr[:, None])
    out = torch.where(fit[None], best, 0.0)
    return out.to(torch.int32).to(torch.uint8)


def _map_flat(kernel, rgb_u8, alpha, centers_f32, k_real, brightness_thr):
    if rgb_u8.dim() != 4 or rgb_u8.shape[3] != 3:
        raise ValueError("quantize_map_flat takes (B, H, W, 3) uint8, got "
                         f"{tuple(rgb_u8.shape)}")
    b, h, w, _ = rgb_u8.shape
    out = kernel(split_planes(rgb_u8), alpha.reshape(b, h * w), centers_f32,
                 k_real, brightness_thr)
    return stack_planes(out, h, w)


def quantize_map_flat(rgb_u8: torch.Tensor, alpha: torch.Tensor,
                      centers_f32: torch.Tensor, k_real: int,
                      brightness_thr: torch.Tensor) -> torch.Tensor:
    """`kernels/quantize.quantize_map`'s contract through the planar
    kernel: rgb_u8 (B, H, W, 3) uint8, alpha (B, H, W) -> (B, H, W, 3)."""
    return _map_flat(quantize_planes, rgb_u8, alpha, centers_f32, k_real,
                     brightness_thr)


def quantize_map_flat_plain(rgb_u8: torch.Tensor, alpha: torch.Tensor,
                            centers_f32: torch.Tensor, k_real: int,
                            brightness_thr: torch.Tensor) -> torch.Tensor:
    """The whole function on the plain version of the kernel."""
    return _map_flat(quantize_planes_plain, rgb_u8, alpha, centers_f32,
                     k_real, brightness_thr)
