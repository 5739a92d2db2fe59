"""The benchmark's photo corpus, its PNG decoder, Pillow's bilinear
resample and the photo mosaic: frozen copies, so that the yardstick stays
as it is when the program changes.

- The 14 photos are PNGs in `benchmark/corpus/`, listed with their
  sources, licences, shapes and sha256s in `MANIFEST.json` there (a copy
  of the port's `bench/corpus/`). A photo that is missing, or whose
  decoded bytes are not the manifest's, raises.
- `png_decode` is the port's CLI codec (`cli._png_decode`): 8-bit grey,
  RGB and RGBA, not interlaced.
- `pil_bilinear_u8` is the port's `bench/corpus.pil_bilinear_u8`:
  Pillow's 8-bit `Image.BILINEAR` resample (Resample.c), the horizontal
  pass and then the vertical one, each in 22-bit fixed point with the
  weights rounded as Pillow rounds them. It accumulates in int32, which
  holds every sum: the weights of an output add up to 2^22, so a sum is
  below 255 * 2^22 + 2^21 < 2^31.
- `mosaic` is the port's `bench/bench.photo_batch` with an offset: image
  i of a batch at offset o is tiled from the corpus at `tile` x `tile`
  row by row, tile (o + i + r * cols + c) mod 14 at row r and column c,
  and cropped to (h, w). At offset 0 it is `photo_batch`'s batch.
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib
from pathlib import Path

import numpy as np

CORPUS = Path(__file__).resolve().parent.parent / "corpus"
PRECISION_BITS = 22           # Pillow's 8-bit resample: 32 - 8 - 2

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth) of
    non-interlaced 8-bit rows; returns (h, w * bpp) uint8."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG: image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            row, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def png_decode(data: bytes) -> np.ndarray:
    """HxWx4 uint8 RGBA of an 8-bit grey, RGB or RGBA, non-interlaced PNG."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError("PNG: chunk tRNS is not supported")
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, method, filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace or method or filt:
        raise ValueError(f"PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} is not supported")
    bpp = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(
        h, w, bpp)
    if bpp == 4:
        return px
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = px
    return rgba


def manifest() -> list:
    """The manifest's photo entries, in load order."""
    with open(CORPUS / "MANIFEST.json") as f:
        entries = json.load(f)["photos"]
    return sorted(entries, key=lambda e: e["order"])


def read_photo(entry: dict) -> np.ndarray:
    """One manifest entry's PNG as (H, W, 3) u8, held to its shape and
    sha256."""
    rgb = np.ascontiguousarray(
        png_decode((CORPUS / entry["file"]).read_bytes())[..., :3])
    digest = hashlib.sha256(rgb.tobytes()).hexdigest()
    if list(rgb.shape) != entry["shape"] or digest != entry["sha256"]:
        raise ValueError(f"corpus photo {entry['file']}: shape {rgb.shape} "
                         "or sha256 differs from the manifest")
    return rgb


def center_square(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    return img[y0:y0 + s, x0:x0 + s]


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs and normalize_coeffs_8bpc for the
    bilinear filter (support 1): (source index, integer weight) tables of
    shape (out_size, taps), zero weights past each output's taps."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    taps = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    idx = np.zeros((out_size, taps), np.int64)
    kk = np.zeros((out_size, taps), np.int32)
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
                  np.int32)
    shape = (-1,) + (1,) * (src.ndim - 1)
    for j in range(idx.shape[1]):
        acc += src[idx[:, j]].astype(np.int32) * kk[:, j].reshape(shape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """`Image.fromarray(img).resize((w, h), Image.BILINEAR)` of an (H, W)
    or (H, W, C) u8 array, to `size` = (h, w) or an int for a square."""
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


def load_tiles(tile: int) -> list:
    """The corpus in manifest order, each photo's centre square resized to
    (tile, tile): a list of (tile, tile, 3) u8."""
    return [pil_bilinear_u8(center_square(read_photo(e)), tile)
            for e in manifest()]


def mosaic(tiles: list, offset: int, b: int, h: int, w: int) -> np.ndarray:
    """(b, h, w, 3) u8: image i tiled row by row, tile (offset + i +
    r * cols + c) mod len(tiles) at row r and column c, cropped to (h, w)."""
    t = tiles[0].shape[0]
    cols, rows = -(-w // t), -(-h // t)
    out = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        canvas = np.concatenate([
            np.concatenate([tiles[(offset + i + r * cols + c) % len(tiles)]
                            for c in range(cols)], axis=1)
            for r in range(rows)], axis=0)
        out[i] = canvas[:h, :w]
    return out
