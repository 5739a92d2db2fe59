"""The photo corpus of the measuring programs, read from the package.

Counterpart of the JAX package's tests/helpers/corpus.py, without Pillow,
sklearn, labmaze or cv2: the photos are PNGs in `corpus/` beside this file
(written once by `corpus/make_corpus.py`, listed with their sources,
licences, shapes and sha256s in `corpus/MANIFEST.json`), decoded by the
CLI's own PNG codec, so that a machine with numpy alone reads them.

- `load_corpus(size, limit, working_image)`: the JAX helper's (name, rgb)
  list, in its order, with the same bytes: each photo's centre square
  resized to (size, size) by `pil_bilinear_u8`.
- `pil_bilinear_u8`: Pillow's 8-bit `Image.BILINEAR` resample (its
  Resample.c): horizontal pass, then vertical, each in 22-bit fixed point
  with the weights rounded as Pillow rounds them and a u8 between the two.
- `synthetic_alpha_init`: the helper's stand-in for a segmentation net's
  alpha (Otsu side in an ellipse, 7x7 close, Gaussian blur at sigma 1.5),
  with cv2's arithmetic written out so that it gives cv2's bytes.

A missing photo, or one whose decoded bytes are not the manifest's, raises.
"""

from __future__ import annotations

import hashlib
import json
from fractions import Fraction
from functools import lru_cache
from pathlib import Path

import numpy as np

from image_segmenter_tpu_torch.cli import _png_decode

CORPUS = Path(__file__).resolve().parent / "corpus"
MANIFEST = CORPUS / "MANIFEST.json"
WORKING_IMAGE_AT = 2          # the working image's index in the JAX order
PRECISION_BITS = 22           # Pillow's 8-bit resample: 32 - 8 - 2


def manifest() -> list:
    """The manifest's photo entries, in load order."""
    with open(MANIFEST) as f:
        entries = json.load(f)["photos"]
    return sorted(entries, key=lambda e: e["order"])


def rgb_sha256(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def read_photo(entry: dict) -> np.ndarray:
    """One manifest entry's PNG as (H, W, 3) u8, held to its shape and
    sha256."""
    rgb = _png_decode((CORPUS / entry["file"]).read_bytes())[..., :3]
    rgb = np.ascontiguousarray(rgb)
    if list(rgb.shape) != entry["shape"] or rgb_sha256(rgb) != entry["sha256"]:
        raise ValueError(f"corpus photo {entry['file']}: shape {rgb.shape} "
                         "or sha256 differs from the manifest")
    return rgb


def read_working_image(path) -> np.ndarray:
    """The reference app's working image as (H, W, 3) u8; needs Pillow."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def center_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return img[y0:y0 + s, x0:x0 + s]


def load_corpus(size: int = 256, limit: int | None = None,
                working_image=None) -> list:
    """[(name, (size, size, 3) u8 RGB)] of the corpus in the JAX helper's
    order; the working image (read with Pillow from the path
    `working_image`, where one is given) joins third."""
    entries = [(e["name"], e) for e in manifest()]
    if working_image is not None:
        entries.insert(WORKING_IMAGE_AT, ("working_image", working_image))
    if limit is not None:
        entries = entries[:limit]
    out = []
    for name, src in entries:
        rgb = (read_photo(src) if isinstance(src, dict)
               else read_working_image(src))
        out.append((name, pil_bilinear_u8(center_square(rgb), size)))
    return out


# ---------------------------------------------------------------------------
# Pillow's 8-bit bilinear resample
# ---------------------------------------------------------------------------

def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for the
    bilinear filter (support 1) over the whole input: (source index,
    integer weight) tables of shape (out_size, taps), zero weights past
    each output's taps."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    taps = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    idx = np.zeros((out_size, taps), np.int64)
    kk = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for w in ws:
            ww += w
        for x, w in enumerate(ws):
            w = w / ww if ww != 0.0 else w
            kk[xx, x] = int(0.5 + w * (1 << PRECISION_BITS))  # w >= 0
            idx[xx, x] = xmin + x
        idx[xx, xmax:] = xmin
    return idx, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    src = np.moveaxis(img, axis, 0)
    idx, kk = _bilinear_coeffs(src.shape[0], out_size)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    shape = (-1,) + (1,) * (src.ndim - 1)
    for j in range(idx.shape[1]):
        acc += src[idx[:, j]].astype(np.int64) * kk[:, j].reshape(shape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """`Image.fromarray(img).resize((w, h), Image.BILINEAR)` of an (H, W)
    or (H, W, C) u8 array, to `size` = (h, w) or an int for a square:
    Pillow's two fixed-point passes, horizontal first, each skipped where
    its side keeps its length."""
    h, w = (size, size) if isinstance(size, int) else size
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"pil_bilinear_u8 takes (H, W[, C]) uint8, not "
                         f"{img.dtype} {img.shape}")
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, axis=1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, axis=0)
    return np.array(out) if out is img else out


# ---------------------------------------------------------------------------
# the stand-in alpha, cv2's arithmetic without cv2
# ---------------------------------------------------------------------------

# cv2.getGaussianKernel(13, 1.5, cv2.CV_64F): OpenCV's bit-exact kernel
# (softdouble exp), which differs from libm's exp in the last bit of some
# taps; GaussianBlur at sigma 1.5 on float64 takes cvRound(1.5*4*2+1)|1 = 13
# taps. Symmetric: taps 0-6, the centre last.
_GAUSS13_HALF = tuple(float.fromhex(x) for x in (
    "0x1.7638649a0fcd1p-14", "0x1.0d891ab536808p-10", "0x1.f1e741f80c9b6p-8",
    "0x1.26dd9e7a284e1p-5", "0x1.bfdc88289323dp-4", "0x1.b42851d1c8a97p-3",
    "0x1.1058ef29a59d7p-2"))


def _gauss13() -> np.ndarray:
    half = np.array(_GAUSS13_HALF)
    return np.concatenate([half, half[-2::-1]])


def rgb_to_gray_cv(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2GRAY) on u8: BT.601 weights in 15-bit
    fixed point, rounded."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(
        np.uint8)


def otsu_threshold_cv(gray: np.ndarray) -> int:
    """cv2's Otsu threshold of a u8 image (getThreshVal_Otsu_8u), its
    float64 sums in its order."""
    hist = np.bincount(gray.ravel(), minlength=256)
    scale = 1.0 / gray.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = max_sigma = 0.0
    best = 0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = float(hist[i]) * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, best = sigma, i
    return best


def _box_extreme(a: np.ndarray, k: int, fill: int, reduce) -> np.ndarray:
    """A k x k max or min filter centred on each pixel, the border filled
    with `fill` (separable: rows, then columns)."""
    r = k // 2
    view = np.lib.stride_tricks.sliding_window_view
    a = reduce(view(np.pad(a, ((r, r), (0, 0)), constant_values=fill), k,
                    axis=0), axis=-1)
    return reduce(view(np.pad(a, ((0, 0), (r, r)), constant_values=fill), k,
                       axis=1), axis=-1)


def morph_close_cv(a: np.ndarray, k: int = 7) -> np.ndarray:
    """cv2.morphologyEx(a, MORPH_CLOSE, np.ones((k, k))) on u8: dilate,
    then erode, the border never winning (OpenCV's default)."""
    return _box_extreme(_box_extreme(a, k, 0, np.max), k, 255, np.min)


@lru_cache(maxsize=2)
def _row_table(fused: bool) -> np.ndarray:
    """OpenCV's float64 row pass of the 13-tap kernel over 0 / 255 input,
    for each of the 2^13 patterns of a window (bit j: tap j is 255): the
    first tap's product, then a tap at a time, each step rounded once,
    in exact fractions. `fused`: a step is one multiply-add (the build
    contracts `s += k * x` in its loop over four columns at a time); else
    the product is rounded first (its loop over the last width % 4
    columns)."""
    k = [Fraction(v) for v in _gauss13()]
    level = {0: 0.0, 1: float(k[0] * 255)}
    for j in range(1, 13):
        nxt = {}
        for bits, acc in level.items():
            prod = k[j] * 255 if fused else Fraction(float(k[j] * 255))
            nxt[bits] = acc
            nxt[bits | (1 << j)] = float(prod + Fraction(acc))
        level = nxt
    table = np.empty(1 << 13)
    for bits, acc in level.items():
        table[bits] = acc
    return table


def _reflect101(a: np.ndarray, r: int, axis: int) -> np.ndarray:
    pad = [(0, 0)] * a.ndim
    pad[axis] = (r, r)
    return np.pad(a, pad, mode="reflect")


def gaussian_blur13_binary(core: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(core * 255.0, (0, 0), 1.5) of a 0 / 1 (H, W)
    image, at least 2 pixels a side, float64: reflect-101 border; the row
    pass by the exact tables above, the column pass symmetric (centre tap,
    then each pair of rows summed and multiplied), unfused."""
    k = _gauss13()
    r = 6
    h, w = core.shape
    if min(h, w) < 2:
        raise ValueError(f"gaussian_blur13_binary needs 2 pixels a side, "
                         f"not {core.shape}")
    bits = _reflect101(core.astype(np.int64) & 1, r, axis=1)
    code = np.zeros((h, w), np.int64)
    for j in range(13):
        code |= bits[:, j:j + w] << j
    body = w - w % 4
    rows = np.concatenate([_row_table(True)[code[:, :body]],
                           _row_table(False)[code[:, body:]]], axis=1)
    rows = _reflect101(rows, r, axis=0)
    out = k[r] * rows[r:r + h]
    for j in range(1, r + 1):
        out = out + k[r + j] * (rows[r + j:r + j + h] + rows[r - j:r - j + h])
    return out


def synthetic_alpha_init(rgb: np.ndarray, seed: int = 0) -> np.ndarray:
    """The JAX helper's deterministic photo-dependent alpha (its docstring
    says why: a segmentation net's saturated foreground and background with
    a few-pixel soft band), with the same bytes: the Otsu side of the grey
    image inside a centred ellipse, closed 7x7 (the other side where that
    covers under 5 %), blurred at sigma 1.5, clipped and truncated to u8.
    `seed` is unused, as in the helper."""
    gray = rgb_to_gray_cv(rgb)
    otsu = gray > otsu_threshold_cv(gray)
    h, w = gray.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ellipse = (((yy - h / 2) / (0.42 * h)) ** 2
               + ((xx - w / 2) / (0.42 * w)) ** 2) < 1.0
    core = morph_close_cv((otsu & ellipse).astype(np.uint8))
    if core.sum() < 0.05 * h * w:  # the Otsu side was the background
        core = morph_close_cv((~otsu & ellipse).astype(np.uint8))
    soft = gaussian_blur13_binary(core)
    return np.clip(soft, 0, 255).astype(np.uint8)
