"""RS: a u8 resize as one banded kernel, u8 in and u8 out.

Replaces no TPU kernel: the JAX package leaves its resizes to XLA's dot
over dense (dst, src) weight matrices (ops/resize.py), and so did the
port, as two dense float64 GEMMs with a float64 copy of the batch on
either side. The weights are a band of a few taps an output, so almost
every multiply-add of those GEMMs was by zero. csrc/resample.cu says
what bounds the kernel and how it is tiled.

A resize is `out = W_y @ img @ W_x^T` for each image and channel. Each
axis's weights come as a `Band`: for output index d, the source window
start[d] .. start[d] + K - 1 and its K float32 taps, the weight
matrix's row d over that window (zeros included), so the band holds
every nonzero of the row and reconstructs the matrix exactly (`band`).
The kernel sums, in float64 and in ascending source index, first the
rows (W_y) into a float64 tile in shared memory, then the columns
(W_x); it rounds once to float32, then floor(x + 0.5), clamps to 0..255
and writes u8: ops/resize.resize_u8's arithmetic, whose module docstring
says why the bytes are the dense contraction's.

`resample_u8` takes card tensors only; the CPU keeps the dense
contraction (ops/resize.resize_u8_plain), the kernel's plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process; a resize is one
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

TILE_BYTES = 64 * 1024     # float64 row sums a block aims at: three an SM
MAX_TILE_BYTES = 232_448   # the most shared memory a block may take (H100)
GROUP = 4                  # output rows a thread sums at once (kRows)
MAX_ROWS = 32              # output rows a block
MAX_COLUMNS = 512          # output columns a block
MAX_OUTPUTS = 16384        # outputs (rows x columns x channels) a block
PAD = 6                    # bytes a row of sums may take beyond the span

class Band(NamedTuple):
    """One axis's weights on the device: output d reads source indices
    start[d] .. start[d] + K - 1 with weights taps[d]."""
    start: torch.Tensor  # int32 (dst,), non-decreasing
    taps: torch.Tensor   # (dst, K) float32 values held as float64


def band(w: np.ndarray) -> tuple:
    """(start int32 (dst,), taps float32 (dst, K)) of a (dst, src) float32
    weight matrix: K the widest span of a row's nonzeros, each window
    moved left where it would pass the source's end. Raises unless the
    windows' starts never decrease (every method's do), which the
    kernel's tiles rest on."""
    dst, src = w.shape
    nz = w != 0
    rows = nz.any(axis=1)
    first = np.where(rows, nz.argmax(axis=1), 0)
    last = np.where(rows, src - 1 - nz[:, ::-1].argmax(axis=1), 0)
    k = int(max(1, (last - first + 1)[rows].max(initial=1)))
    # a row of zeros takes the window of the row before it
    start = np.minimum(np.maximum.accumulate(first), src - k)
    if np.any(rows & ((first < start) | (last >= start + k))):
        raise ValueError("resample: the weights' windows do not advance "
                         "with the output index")
    taps = np.take_along_axis(w, start[:, None] + np.arange(k), axis=1)
    return start.astype(np.int32), np.ascontiguousarray(taps, np.float32)


def span(start: np.ndarray, k: int, t: int) -> int:
    """The most source indices that `t` consecutive outputs of one tile
    read together (the tiles start at multiples of t)."""
    n = len(start)
    lo = np.arange(0, n, t)
    hi = np.minimum(lo + t, n) - 1
    return int((start[hi] + k - start[lo]).max())


def tile(start_x: np.ndarray, kx: int, dh: int, c: int) -> tuple:
    """(rows, columns, span) of a block's output tile for `c` channels:
    the most columns, up to MAX_COLUMNS, for which GROUP rows of float64
    sums over the span's bytes (and PAD more, where the kernel aligns its
    loads) fit TILE_BYTES, then as many rows as fit it, up to MAX_ROWS and
    MAX_OUTPUTS. Where not even one column fits, one row and one column in
    up to MAX_TILE_BYTES; else it raises."""
    dw = len(start_x)

    def row_bytes(sp):
        return (sp * c + PAD) * 8

    group = min(GROUP, dh)
    for tx in range(min(dw, MAX_COLUMNS), 0, -1):
        sp = span(start_x, kx, tx)
        if group * row_bytes(sp) <= TILE_BYTES:
            ty = min(dh, MAX_ROWS, TILE_BYTES // row_bytes(sp),
                     max(group, MAX_OUTPUTS // (tx * c)))
            return ty, tx, sp
    sp = span(start_x, kx, 1)
    if row_bytes(sp) > MAX_TILE_BYTES:
        raise ValueError(f"resample: one output column reads {sp} source "
                         f"columns of {c} channels, more than a block's "
                         "shared memory holds")
    return 1, 1, sp

def resample_u8(img: torch.Tensor, by: Band, bx: Band, tiles: tuple
                ) -> torch.Tensor:
    """(B, H, W) or (B, H, W, C) contiguous uint8 on the card -> (B, H',
    W'[, C]) uint8, H' and W' the bands' lengths; `tiles` is `tile`'s
    (rows, columns, span) for these bands and channels. The result is laid
    out as the dense contraction leaves it, each output row's channels
    one after the other ((B, H', C, W') permuted): the operations after
    a resize that reduce over it sum in an order that follows the layout,
    so any other would change their floats."""
    global LAUNCHES
    if (img.dtype != torch.uint8 or not img.is_cuda
            or not img.is_contiguous() or img.dim() not in (3, 4)):
        raise ValueError("resample_u8 takes a contiguous (B, H, W[, C]) "
                         f"uint8 tensor on the card; got {tuple(img.shape)} "
                         f"{img.dtype} {img.device}")
    b, h, w = img.shape[:3]
    c = img.shape[3] if img.dim() == 4 else 1
    dh, ky = by.taps.shape
    dw, kx = bx.taps.shape
    for bd in (by, bx):
        if (bd.start.device != img.device or bd.taps.device != img.device
                or bd.start.dtype != torch.int32
                or bd.taps.dtype != torch.float64):
            raise ValueError("resample_u8 takes int32 starts and float64 "
                             "taps on the input's device")
    planar = torch.empty((b, dh, c, dw), dtype=torch.uint8,
                         device=img.device)
    out = planar.permute(0, 1, 3, 2) if img.dim() == 4 else planar[:, :, 0]
    if out.numel() == 0:
        return out
    ty, tx, sp = tiles
    stream = torch.cuda.current_stream(img.device).cuda_stream
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(img.device):
        rc = _build.library().iseg_resample_u8(
            img.data_ptr(), b, h, w, c, by.start.data_ptr(),
            by.taps.data_ptr(), dh, ky, bx.start.data_ptr(),
            bx.taps.data_ptr(), dw, kx, ty, tx, sp, planar.data_ptr(), stream)
    _build.check(rc, "resample_u8")
    LAUNCHES += 1
    return out
