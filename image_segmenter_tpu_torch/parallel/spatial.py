"""Row-blocked activations: U^2-Net's training step with image rows split
over the space slots of a mesh.

Counterpart of what GSPMD does for image_segmenter_tpu/pipeline/train.py's
`shard_train_step`, whose batch lies on P(DATA, SPACE, None, None): XLA
splits every convolution by image rows and exchanges halo rows, and sums
the BatchNorm statistics and the loss over the row shards. Here the single
controller does it by hand on a `Rows`, one activation held as blocks:
block (g, j) is data group g's images, rows `bounds[j]` of the level, on
slot (g, j)'s device. Every op below takes and gives `Rows`, reads the
rows its window needs from the neighbouring blocks (`gather`) and is
differentiable through autograd: the backward of a gather (`narrow`,
`torch.cat`, `Tensor.to`) adds the ghost rows' gradients back to the
block that owns them. No slot ever holds more of an activation than its
own rows and the halo its window reads.

Row bounds follow the levels: the input's rows split as
`torch.tensor_split` splits them, and the 2 x 2 ceil-mode pool gives a
block [lo, hi) the rows [ceil(lo / 2), ceil(hi / 2)) of the next level, so
a block may be empty at a deep level. An empty block computes nothing and
adds nothing to a sum.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.parallel.mesh import split_bounds, take, \
    to_slot


def _ceil2(n: int) -> int:
    return -(-n // 2)


class Rows:
    """An activation (B, C, H, W) split into row blocks over a grid of
    slots: `blocks[g][j]` holds data group g's images, rows
    `bounds[j]` = [lo, hi) of the `height` rows, on its slot's device.

    Arithmetic with a tensor (a per-channel vector shaped (C, 1, 1))
    copies the tensor to each block's device; arithmetic with another
    `Rows` of the same level works block by block."""

    def __init__(self, blocks: List[List[torch.Tensor]],
                 bounds: Sequence[tuple], height: int):
        self.blocks = blocks
        self.bounds = [tuple(b) for b in bounds]
        self.height = height
        for group in blocks:
            for blk, (lo, hi) in zip(group, self.bounds):
                if blk.shape[2] != hi - lo:
                    raise ValueError(f"a block of {blk.shape[2]} rows for "
                                     f"rows [{lo}, {hi})")

    @classmethod
    def split(cls, x: torch.Tensor, devices: np.ndarray) -> "Rows":
        """x (B, C, H, W) split over a (groups, slots) grid of devices: the
        batch over the groups and the rows over each group's slots, as
        `torch.tensor_split` cuts them (the first pieces one longer)."""
        groups, slots = devices.shape
        bounds = split_bounds(x.shape[2], slots)
        blocks = [[to_slot(x[b0:b1, :, lo:hi], devices[g, j])
                   for j, (lo, hi) in enumerate(bounds)]
                  for g, (b0, b1) in enumerate(split_bounds(x.shape[0],
                                                            groups))]
        return cls(blocks, bounds, x.shape[2])

    @property
    def width(self) -> int:
        return self.blocks[0][0].shape[3]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    @property
    def first(self) -> torch.device:
        """The device of slot (0, 0), where the sums are added."""
        return self.blocks[0][0].device

    def flat(self) -> List[torch.Tensor]:
        return [blk for group in self.blocks for blk in group]

    def map(self, fn: Callable, *tensors: torch.Tensor) -> "Rows":
        """fn(block, *tensors on the block's device) for every block."""
        return Rows([[fn(blk, *(to_slot(t, blk.device) for t in tensors))
                      for blk in group] for group in self.blocks],
                    self.bounds, self.height)

    def zip(self, fn: Callable, *others: "Rows") -> "Rows":
        """fn(block, the blocks of `others` at the same slot), block by
        block; every operand is of this level."""
        for o in others:
            if o.bounds != self.bounds or o.height != self.height:
                raise ValueError("row blocks of different levels")
        return Rows([[fn(*blks) for blks in zip(*groups)]
                     for groups in zip(self.blocks,
                                       *(o.blocks for o in others))],
                    self.bounds, self.height)

    def _binary(self, other, op) -> "Rows":
        if isinstance(other, Rows):
            return self.zip(op, other)
        return self.map(op, other)

    def __add__(self, other):
        return self._binary(other, torch.add)

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    def to(self, dtype: torch.dtype) -> "Rows":
        return self.map(lambda blk: blk.to(dtype))

    def relu(self) -> "Rows":
        return self.map(torch.relu)

    def sigmoid(self) -> "Rows":
        return self.map(torch.sigmoid)


def gather(x: Rows, g: int, j: int, a: int, b: int) -> torch.Tensor:
    """Rows [a, b) of data group g's activation on slot (g, j)'s device,
    with zero rows outside [0, H). The range may reach over several
    blocks (`parallel/mesh.take`): a halo can be wider than a neighbour's
    block."""
    own = x.blocks[g][j]
    bsz, c, _, w = own.shape
    top, bottom = max(0, min(b, 0) - a), max(0, b - max(a, x.height))
    parts = [own.new_zeros((bsz, c, top, w))] if top else []
    if max(a, 0) < min(b, x.height):
        parts.append(take(x.blocks[g], x.bounds, max(a, 0),
                          min(b, x.height), own.device, dim=2))
    if bottom:
        parts.append(own.new_zeros((bsz, c, bottom, w)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, 2)


def _empty(x: Rows, g: int, j: int, c: int, w: int) -> torch.Tensor:
    own = x.blocks[g][j]
    return own.new_zeros((own.shape[0], c, 0, w))


def conv2d(x: Rows, weight: torch.Tensor, bias, dilation: int = 1) -> Rows:
    """A stride-1 convolution with a k x k kernel (k odd) and zero
    padding dilation * (k // 2), as the whole tensor's: each block reads
    its rows and `dilation * (k // 2)` halo rows on each side (zero rows
    past the image's edges) and pads only the width."""
    halo = dilation * (weight.shape[-1] // 2)
    out = []
    for g, group in enumerate(x.blocks):
        row = []
        for j, (lo, hi) in enumerate(x.bounds):
            if lo == hi:
                row.append(_empty(x, g, j, weight.shape[0], x.width))
                continue
            dev = group[j].device
            row.append(F.conv2d(
                gather(x, g, j, lo - halo, hi + halo), to_slot(weight, dev),
                None if bias is None else to_slot(bias, dev),
                padding=(0, halo), dilation=dilation))
        out.append(row)
    return Rows(out, x.bounds, x.height)


def maxpool2(x: Rows) -> Rows:
    """The 2 x 2, stride-2 max pool with ceil_mode (the JAX package's
    (0, 1) padding on odd sizes): block [lo, hi) gives rows
    [ceil(lo / 2), ceil(hi / 2)) of the next level from rows
    [2 ceil(lo / 2), 2 ceil(hi / 2)) of this one, so a block whose `lo` is
    odd lends its first row to the block above."""
    bounds = [(_ceil2(lo), _ceil2(hi)) for lo, hi in x.bounds]
    out = []
    for g in range(len(x.blocks)):
        row = []
        for j, (a, b) in enumerate(bounds):
            if a == b:
                row.append(_empty(x, g, j, x.blocks[g][j].shape[1],
                                  _ceil2(x.width)))
                continue
            src = gather(x, g, j, 2 * a, min(2 * b, x.height))
            row.append(F.max_pool2d(src, 2, 2, ceil_mode=True))
        out.append(row)
    return Rows(out, bounds, _ceil2(x.height))


@functools.lru_cache(maxsize=4096)
def _weights(in_size: int, out_size: int, lo: int, hi: int,
             dtype: torch.dtype, device: torch.device):
    """Bilinear, align_corners=False, as PyTorch indexes it: output row r
    of [lo, hi) reads rows i0 = floor(s) and i1 = min(i0 + 1, in - 1)
    with weights 1 - l and l, where s = max((r + 0.5) * in / out - 0.5, 0)
    and l = s - i0, in the input's precision (PyTorch's accumulate type of
    float32 and float64 on the CPU and the card). Returns the source rows
    [a, b) that the block reads, and i0 - a, i1 - a and the two weights
    (shaped to scale rows) on `device`. They are kept: a training step
    resizes the same levels every time, and a copy to the card waits for
    its stream."""
    ft = np.float64 if dtype == torch.float64 else np.float32
    scale = ft(in_size) / ft(out_size)
    s = np.maximum(scale * (np.arange(lo, hi).astype(ft) + ft(0.5))
                   - ft(0.5), ft(0))
    i0 = np.minimum(np.floor(s).astype(np.int64), in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    l1 = np.clip(s - i0.astype(ft), ft(0), ft(1)).astype(ft)
    a = int(i0[0])
    shape = (1, 1, hi - lo, 1)
    return (a, int(i1[-1]) + 1, torch.from_numpy(i0 - a).to(device),
            torch.from_numpy(i1 - a).to(device),
            torch.from_numpy((ft(1) - l1).astype(ft)).to(device).view(shape),
            torch.from_numpy(l1).to(device).view(shape))


def upsample(x: Rows, ref: Rows) -> Rows:
    """Bilinear resize (align_corners=False) of `x` to `ref`'s level:
    each block of `ref`'s rows gathers the source rows its output rows
    read, resizes their width with F.interpolate and then forms its rows
    from them with the whole resize's weights (F.interpolate on a block
    alone would take the scale from the block's sizes). float32 and
    float64: the network resizes bfloat16 in another order
    (models/u2net.upsample_like), which no training step runs."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"row-blocked upsample of {x.dtype}")
    w_out = ref.width
    if x.height == ref.height:
        if x.bounds != ref.bounds:
            raise ValueError("row blocks of one size, other bounds")
        if x.width == w_out:
            return x
    out = []
    for g in range(len(x.blocks)):
        row = []
        for j, (lo, hi) in enumerate(ref.bounds):
            if lo == hi:
                row.append(_empty(x, g, j, x.blocks[g][j].shape[1], w_out))
                continue
            dev = ref.blocks[g][j].device
            if x.height == ref.height:
                src = x.blocks[g][j]
            else:
                a, b, i0, i1, w0, w1 = _weights(x.height, ref.height, lo,
                                                hi, x.dtype, dev)
                src = gather(x, g, j, a, b)
            if x.width != w_out:
                bsz, c, n, w = src.shape
                src = F.interpolate(src.reshape(bsz, c * n, w), size=w_out,
                                    mode="linear", align_corners=False) \
                    .reshape(bsz, c, n, w_out)
            if x.height == ref.height:
                row.append(src)
                continue
            row.append(src.index_select(2, i0) * w0
                       + src.index_select(2, i1) * w1)
        out.append(row)
    return Rows(out, ref.bounds, ref.height)


def cat(xs: Sequence[Rows]) -> Rows:
    """Channel concatenation, block by block."""
    return xs[0].zip(lambda *blks: torch.cat(blks, 1), *xs[1:])


def channel_sums(y) -> torch.Tensor:
    """Per channel sum(y), sum(y * y) and the count of each, (2C + 1,), of
    a tensor (B, C, H, W), or over every non-empty block of row blocks,
    added on slot (0, 0)'s device."""
    blocks, first = (y.flat(), y.first) if isinstance(y, Rows) \
        else ([y], y.device)
    parts = []
    for blk in blocks:
        if blk.shape[2] == 0:
            continue
        c = blk.shape[1]
        count = torch.full((1,), blk.numel() // c, dtype=blk.dtype,
                           device=blk.device)
        parts.append(to_slot(torch.cat([blk.sum((0, 2, 3)),
                                        (blk * blk).sum((0, 2, 3)), count]),
                             first))
    return parts[0] if len(parts) == 1 else torch.stack(parts).sum(0)
