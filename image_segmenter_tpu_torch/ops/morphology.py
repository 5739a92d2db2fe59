"""Morphology, Gaussian blur and box sums with cv2 semantics.

Counterpart of image_segmenter_tpu/ops/morphology.py.

Binary erosion and dilation are a min/max over the structuring element's
taps, each tap a shifted read of the padded mask, batched over a leading
axis; the border fill follows cv2's defaults: dilation pads with 0, erosion
with 1 (the border never shrinks the mask). cv2 reads src(p + k - anchor)
with anchor = ksize // 2 for both, with no flip, which matters for even
sizes. The JAX package switches to a convolution for elements of more than
26 taps; on a binary mask both give the same bits, so the port keeps the
shift reduction for every size.

Grey erosion and dilation are the same shift trees in float32 with an
infinite fill; the Gaussian blur is separable with a reflect-101 border and
sums its taps in the JAX module's order, one elementwise add at a time, so
it rounds alike on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from image_segmenter_tpu_torch.ops import scan

RECT = "rect"
ELLIPSE = "ellipse"
CROSS = "cross"


# Copied unchanged from image_segmenter_tpu/ops/morphology.py
# (structuring_element): pure numpy, and the port must not import the JAX
# package.
@functools.lru_cache(maxsize=None)
def structuring_element(shape: str, ksize: tuple) -> np.ndarray:
    """cv2.getStructuringElement-compatible binary SE of shape (kh, kw)."""
    kw, kh = int(ksize[0]), int(ksize[1])  # cv2 takes (width, height)
    se = np.zeros((kh, kw), dtype=np.uint8)
    if shape == RECT:
        se[:] = 1
    elif shape == CROSS:
        se[kh // 2, :] = 1
        se[:, kw // 2] = 1
    elif shape == ELLIPSE:
        # Mirror of cv2's rasterization (modules/imgproc/src/morph.cpp).
        r, c = kh // 2, kw // 2
        inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
        for i in range(kh):
            dy = i - r
            if abs(dy) <= r:
                if r > 0:
                    dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
                else:
                    dx = c
                j1 = max(c - dx, 0)
                j2 = min(c + dx + 1, kw)
                se[i, j1:j2] = 1
    else:
        raise ValueError(f"unknown SE shape: {shape}")
    return se


def _shift_reduce(mask_b: torch.Tensor, se: np.ndarray,
                  is_dilate: bool) -> torch.Tensor:
    """OR (dilate) or AND (erode) over the SE's taps of a (B, H, W) bool
    mask. cv2 reads src(p + k - anchor) for both (no kernel flip),
    anchor = ksize // 2."""
    kh, kw = se.shape
    cy, cx = kh // 2, kw // 2
    b, h, w = mask_b.shape
    pad_y = max(cy, kh - 1 - cy)
    pad_x = max(cx, kw - 1 - cx)
    mp = torch.full((b, h + 2 * pad_y, w + 2 * pad_x), not is_dilate,
                    dtype=torch.bool, device=mask_b.device)
    mp[:, pad_y:pad_y + h, pad_x:pad_x + w] = mask_b
    out = None
    for i in range(kh):
        for j in range(kw):
            if not se[i, j]:
                continue
            dy, dx = i - cy, j - cx
            s = mp[:, pad_y + dy:pad_y + dy + h, pad_x + dx:pad_x + dx + w]
            if out is None:
                out = s.clone()
            elif is_dilate:
                out |= s
            else:
                out &= s
    return out


def dilate_binary(mask: torch.Tensor, se: np.ndarray,
                  iterations: int = 1) -> torch.Tensor:
    """Binary dilation; matches cv2.dilate on a {0,255} mask (border=0)."""
    m = mask > 0
    for _ in range(int(iterations)):
        m = _shift_reduce(m, se, is_dilate=True)
    return m


def erode_binary(mask: torch.Tensor, se: np.ndarray,
                 iterations: int = 1) -> torch.Tensor:
    """Binary erosion; matches cv2.erode on a {0,255} mask (border=max)."""
    m = mask > 0
    for _ in range(int(iterations)):
        m = _shift_reduce(m, se, is_dilate=False)
    return m


def open_binary(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return dilate_binary(erode_binary(mask, se), se)


def close_binary(mask: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return erode_binary(dilate_binary(mask, se), se)


def shift2d(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """x shifted so that out[y, x] = x[y + dy, x + dx] over the first two
    axes, `fill` outside the image. Trailing axes ride along."""
    h, w = x.shape[0], x.shape[1]
    out = torch.full_like(x, fill)
    y0, y1 = max(0, -dy), min(h, h - dy)
    x0, x1 = max(0, -dx), min(w, w - dx)
    if y0 < y1 and x0 < x1:
        out[y0:y1, x0:x1] = x[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _conv2d_same(x: torch.Tensor, kernel: np.ndarray,
                 pad_value: float) -> torch.Tensor:
    """2D cross-correlation with SAME padding and a constant border value.

    x: (H, W) float32. kernel: (kh, kw) numpy. Returns (H, W) float32.
    The padding is (k // 2, k - 1 - k // 2) on each axis, as cv2 anchors an
    even kernel.
    """
    kh, kw = kernel.shape
    xp = torch.nn.functional.pad(
        x.to(torch.float32)[None, None],
        (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
        value=float(pad_value))
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    return torch.nn.functional.conv2d(xp, k[None, None])[0, 0]


# ---------------------------------------------------------------------------
# Grayscale morphology (shift trees)
# ---------------------------------------------------------------------------

def _gray_reduce(img: torch.Tensor, se: np.ndarray, is_dilate: bool):
    x = img.to(torch.float32)
    kh, kw = se.shape
    cy, cx = kh // 2, kw // 2
    fill = float("-inf") if is_dilate else float("inf")
    out = None
    for i in range(kh):
        for j in range(kw):
            if se[i, j]:
                s = shift2d(x, i - cy, j - cx, fill)
                if out is None:
                    out = s
                else:
                    out = torch.maximum(out, s) if is_dilate \
                        else torch.minimum(out, s)
    return out


def dilate_gray(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Grayscale dilation (max over SE), cv2 border semantics (min fill).

    cv2 reads src(p + k - anchor) for dilate as well as erode (no flip)."""
    return _gray_reduce(img, se, is_dilate=True)


def erode_gray(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Grayscale erosion (min over SE), cv2 border semantics (max fill)."""
    return _gray_reduce(img, se, is_dilate=False)


def morphological_gradient(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """cv2 MORPH_GRADIENT: dilate - erode, float32 in [0, 255]."""
    x = img.to(torch.float32)
    return torch.clamp(dilate_gray(x, se) - erode_gray(x, se), 0.0, 255.0)


# ---------------------------------------------------------------------------
# Gaussian blur (separable), cv2.GaussianBlur semantics
# ---------------------------------------------------------------------------

# Copied unchanged from image_segmenter_tpu/ops/morphology.py
# (gaussian_kernel_1d): pure numpy.
@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel: if sigma<=0, sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def reflect_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Pad `dim` by r on both sides, reflect-101 (numpy's "reflect", cv2's
    BORDER_REFLECT_101), also where r reaches past the axis."""
    idx = np.pad(np.arange(x.shape[dim]), r, mode="reflect")
    return torch.index_select(x, dim, torch.as_tensor(idx, device=x.device))


def blur_taps(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """sum_i pad(x)[i : i + n] * taps[i] along `dim` (reflect-101 border),
    added one tap at a time in order: taps is a sequence of 0-d float32
    tensors on x's device."""
    r = (len(taps) - 1) // 2
    n = x.shape[dim]
    xp = reflect_pad(x, r, dim)
    acc = None
    for i, t in enumerate(taps):
        term = xp.narrow(dim, i, n) * t
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) or (H, W, C) float image.

    Border: reflect-101 (cv2 default BORDER_REFLECT_101).
    """
    k = gaussian_kernel_1d(int(ksize), float(sigma))
    x = img.to(torch.float32)
    taps = torch.as_tensor(k, device=x.device).unbind(0)
    x = blur_taps(x, taps, 0)
    return blur_taps(x, taps, 1)


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Sum over a (2r+1)^2 window with zero padding, via two prefix-sum
    passes (ops/scan.cumsum: XLA's CPU summation order on every device).
    Accepts (H, W) or (H, W, C)."""
    x = img.to(torch.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    r = int(radius)

    def axis_sum(a: torch.Tensor, axis: int) -> torch.Tensor:
        n = a.shape[axis]
        c = scan.cumsum(a.movedim(axis, -1)).movedim(-1, axis)
        cpad = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], axis)
        ar = torch.arange(n, device=a.device)
        hi = torch.clamp(ar + r + 1, 0, n)
        lo = torch.clamp(ar - r, 0, n)
        return torch.index_select(cpad, axis, hi) \
            - torch.index_select(cpad, axis, lo)

    x = axis_sum(axis_sum(x, 0), 1)
    return x[..., 0] if squeeze else x
