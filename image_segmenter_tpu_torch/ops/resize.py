"""Image resize with cv2/PIL-compatible sampling conventions.

Counterpart of image_segmenter_tpu/ops/resize.py. A resize is two
contractions, out = W_y @ img @ W_x^T, with host-built (dst, src) float32
weight matrices, as the JAX package leaves them to XLA's dot. On the CPU
they are dense `torch.matmul`s (`resize`, and `resize_u8_plain`); on the
card `resize_u8` is one launch of a hand-written kernel
(kernels/resample) that sums only each output's band of nonzero taps
(`_band`), rows then columns, and never holds a float64 plane in device
memory.

The contractions accumulate in float64 and the result is rounded to
float32 once. A float32 product's rounding depends on the order in which
the BLAS library sums, which differs between the CPU and the card; the
float64 sum of float32 terms rounds to the same float32 in any order (up
to a tie at float64 precision), so a u8 resize gives the same bytes on
every device, the banded kernel's order included. Against the JAX
package's float32 contraction the two differ at float32 rounding, as any
two summation orders do.

The port's functions take a leading batch axis: (B, H, W) or (B, H, W, C).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from image_segmenter_tpu_torch.kernels import resample as RS
from image_segmenter_tpu_torch.utils.backend import targets_cuda

AREA = "area"          # cv2 INTER_AREA (exact for downscale)
LINEAR = "linear"      # cv2 INTER_LINEAR (half-pixel centers)
NEAREST_CV = "nearest_cv"    # cv2 INTER_NEAREST (floor(x*scale))
NEAREST_PIL = "nearest_pil"  # PIL Image.NEAREST (floor((x+0.5)*scale))
BILINEAR_PIL = "bilinear_pil"  # PIL BILINEAR (antialiased triangle filter)
LANCZOS_PIL = "lanczos_pil"    # PIL LANCZOS (a=3), used by rembg resizes


# The weight builders below are copied unchanged from
# image_segmenter_tpu/ops/resize.py (_pil_filter_row .. _weights): pure
# numpy, shared semantics, and the port must not import the JAX package.

def _pil_filter_row(dst: int, src: int, support: float, f) -> np.ndarray:
    """PIL Resample.c precompute_coeffs: antialiased filter weights."""
    w = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    filterscale = max(scale, 1.0)
    sup = support * filterscale
    ss = 1.0 / filterscale
    for d in range(dst):
        center = (d + 0.5) * scale
        xmin = max(0, int(center - sup + 0.5))
        xmax = min(src, int(center + sup + 0.5))
        ws = np.array([f((x - center + 0.5) * ss) for x in range(xmin, xmax)])
        tot = ws.sum()
        if tot != 0:
            w[d, xmin:xmax] = ws / tot
    return w.astype(np.float32)


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _lanczos3(x: float) -> float:
    if x == 0.0:
        return 1.0
    if abs(x) >= 3.0:
        return 0.0
    px = np.pi * x
    return 3.0 * np.sin(px) * np.sin(px / 3.0) / (px * px)


@functools.lru_cache(maxsize=None)
def _weights(src: int, dst: int, method: str) -> np.ndarray:
    """(dst, src) row-stochastic resampling weight matrix."""
    w = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    if method == AREA:
        for d in range(dst):
            lo, hi = d * scale, (d + 1) * scale
            s0, s1 = int(np.floor(lo)), int(np.ceil(hi))
            for s in range(s0, min(s1, src)):
                overlap = min(hi, s + 1) - max(lo, s)
                if overlap > 0:
                    w[d, s] = overlap / scale
    elif method == LINEAR:
        for d in range(dst):
            x = (d + 0.5) * scale - 0.5
            x0 = int(np.floor(x))
            f = x - x0
            a = np.clip(x0, 0, src - 1)
            b = np.clip(x0 + 1, 0, src - 1)
            w[d, a] += 1.0 - f
            w[d, b] += f
    elif method == BILINEAR_PIL:
        return _pil_filter_row(dst, src, 1.0, _triangle)
    elif method == LANCZOS_PIL:
        return _pil_filter_row(dst, src, 3.0, _lanczos3)
    elif method == NEAREST_CV:
        for d in range(dst):
            s = min(int(d * scale), src - 1)
            w[d, s] = 1.0
    elif method == NEAREST_PIL:
        # PIL's ImagingTransformAffine accumulates the source coordinate
        # incrementally (xin += scale) instead of multiplying per pixel, so
        # the float64 rounding drift must be simulated to match it exactly.
        xin = scale * 0.5
        for d in range(dst):
            w[d, min(int(xin), src - 1)] = 1.0
            xin += scale
    else:
        raise ValueError(f"unknown resize method: {method}")
    return w


@functools.lru_cache(maxsize=None)
def _weights_on(src: int, dst: int, method: str,
                device: torch.device) -> torch.Tensor:
    """The float32 weights, held as float64 for the contractions."""
    return torch.from_numpy(_weights(src, dst, method)).to(
        device=device, dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _band(src: int, dst: int, method: str) -> tuple:
    """`_weights` as the kernel's band: (start int32 (dst,), taps float32
    (dst, K)), which reconstruct it exactly."""
    return RS.band(_weights(src, dst, method))


@functools.lru_cache(maxsize=None)
def _band_on(src: int, dst: int, method: str,
             device: torch.device) -> RS.Band:
    """The band on `device`, its taps held as float64. Made at a shape's
    first call, so before a CUDA graph captures the resize."""
    start, taps = _band(src, dst, method)
    return RS.Band(torch.from_numpy(start).to(device),
                   torch.from_numpy(taps).to(device, torch.float64))


@functools.lru_cache(maxsize=None)
def _tiles(w: int, dw: int, dh: int, method: str, c: int) -> tuple:
    """The kernel's tile for a resize of width w -> dw to dh rows of c
    channels (kernels/resample.tile), worked out on the host."""
    start, taps = _band(w, dw, method)
    return RS.tile(start, taps.shape[1], dh, c)


def resize(img: torch.Tensor, dst_hw: tuple, method: str = LINEAR) -> torch.Tensor:
    """Resize a (B, H, W) or (B, H, W, C) batch to dst_hw = (H', W').

    Returns float32; use resize_u8 for u8-in/u8-out with cv2 rounding.
    """
    b, h, w = img.shape[:3]
    tail = img.shape[3:]
    dh, dw = int(dst_hw[0]), int(dst_hw[1])
    if (h, w) == (dh, dw):
        return img.to(torch.float32)
    x = img.to(torch.float64)
    wy = _weights_on(h, dh, method, x.device)
    wx = _weights_on(w, dw, method, x.device)
    # rows: (dh, h) @ (b, h, w*c) -> (b, dh, w*c)
    x = torch.matmul(wy, x.reshape(b, h, -1))
    # cols: channels to the front, one (b*dh*c, w) @ (w, dw) product
    c = x.shape[-1] // w
    x = x.reshape(b * dh, w, c).transpose(1, 2).reshape(-1, w)
    x = torch.matmul(x, wx.t()).to(torch.float32)
    return x.reshape(b * dh, c, dw).transpose(1, 2).reshape(b, dh, dw, *tail)


def resize_u8(img: torch.Tensor, dst_hw: tuple, method: str = LINEAR) -> torch.Tensor:
    """uint8 resize with cv2-style round-half-up output conversion. On the
    card one launch of the banded kernel (kernels/resample), which takes
    uint8 only; on the CPU its plain version, `resize_u8_plain`."""
    if not targets_cuda(img):
        return resize_u8_plain(img, dst_hw, method)
    if img.dtype != torch.uint8 or img.dim() not in (3, 4):
        raise ValueError("resize_u8 takes a (B, H, W[, C]) uint8 tensor on "
                         f"the card; got {tuple(img.shape)} {img.dtype}")
    b, h, w = img.shape[:3]
    dh, dw = int(dst_hw[0]), int(dst_hw[1])
    if (h, w) == (dh, dw):
        return img.clone()  # in img's layout, as `resize_u8_plain`
    c = img.shape[3] if img.dim() == 4 else 1
    dev = img.device
    return RS.resample_u8(img.contiguous(), _band_on(h, dh, method, dev),
                          _band_on(w, dw, method, dev),
                          _tiles(w, dw, dh, method, c))


def resize_u8_plain(img: torch.Tensor, dst_hw: tuple,
                    method: str = LINEAR) -> torch.Tensor:
    """`resize_u8` as the dense float64 contractions of `resize`, on any
    device: the kernel's plain version."""
    x = resize(img, dst_hw, method)
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _linear_aa_weights(src: int, dst: int, f64: bool) -> np.ndarray:
    """(dst, src) weights of `jax.image.resize(..., "linear")`, which the
    JAX package's matting pyramid uses: a triangle filter at half-pixel
    centres, widened by the shrink factor when it shrinks (antialiasing)
    and normalised per output sample. Evaluated in the working type
    (float32, or float64 for the float64 rungs) in jax's order of
    operations: the same floats for an even 2:1 shrink, within an ulp or
    two of jax's otherwise (XLA fuses the expression its own way)."""
    dt = np.float64 if f64 else np.float32
    inv_scale = dt(1.0 / (dst / src))  # jax inverts the Python float
    kernel_scale = max(inv_scale, dt(1.0))
    # XLA contracts the product and the subtraction into one fused
    # multiply-add: the float64 product of two float32 values is exact,
    # so rounding after the subtraction gives the same float
    sample_f = ((np.arange(dst, dtype=dt) + dt(0.5)).astype(np.float64)
                * np.float64(inv_scale) - 0.5).astype(dt)
    x = np.abs(sample_f[None, :] - np.arange(src, dtype=dt)[:, None]) \
        / kernel_scale
    w = np.maximum(dt(0.0), dt(1.0) - x)
    tot = w.sum(axis=0, keepdims=True, dtype=dt)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, dt(1.0)), dt(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, dt(0.0)).T
                                .astype(dt))


def resize_linear_aa(img: torch.Tensor, dst_hw: tuple) -> torch.Tensor:
    """`jax.image.resize(img, dst_hw, "linear")` for a (B, H, W) or
    (B, H, W, C) float32 or float64 batch, in the input's type. The
    contractions accumulate in float64 and round once, as `resize` does."""
    b, h, w = img.shape[:3]
    tail = img.shape[3:]
    dh, dw = int(dst_hw[0]), int(dst_hw[1])
    f64 = img.dtype == torch.float64
    x = img.to(torch.float64)
    if h != dh:
        wy = torch.from_numpy(_linear_aa_weights(h, dh, f64)).to(
            device=x.device, dtype=torch.float64)
        x = torch.matmul(wy, x.reshape(b, h, -1))
    if w != dw:
        wx = torch.from_numpy(_linear_aa_weights(w, dw, f64)).to(
            device=x.device, dtype=torch.float64)
        c = x.shape[-1] // w if x.dim() == 3 else int(np.prod(tail, dtype=int))
        x = x.reshape(b * dh, w, c).transpose(1, 2).reshape(-1, w)
        x = torch.matmul(x, wx.t())
        x = x.reshape(b * dh, c, dw).transpose(1, 2)
    return x.reshape(b, dh, dw, *tail).to(img.dtype)


def scale_to_max_dim(h: int, w: int, max_dim: int) -> tuple:
    """The reference's shrink rule: scale = min(max_dim/h, max_dim/w).

    (matting_refine.py:110-111, color_simplify.py:611-612). Returns (new_h,
    new_w) via int() truncation, each clamped to >= 1 as the JAX package
    does for extreme aspect ratios.
    """
    scale = min(max_dim / h, max_dim / w)
    return max(1, int(h * scale)), max(1, int(w * scale))
