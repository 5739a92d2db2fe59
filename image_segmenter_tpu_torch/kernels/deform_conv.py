"""The modulated deformable convolution (DCNv2, Zhu et al. 2019) of
BiRefNet's decoder, as one kernel.

Replaces no TPU kernel: the JAX package has no BiRefNet. It was added
because no library in this environment computes a deformable
convolution (torchvision is not installed), and the plain alternative,
an im2col of bilinear samples in PyTorch operations, materialises a
(B, 64 k^2, H W) operand: 1.6 GB in bfloat16 for the 7 x 7 branch at
4 x 256 x 256. csrc/deform_conv.cu says what bounds it and how it is
tiled.

`deform_conv(x, offset, mask, weight, bias=None, relu=False, out=None)`
is torchvision's `deform_conv2d` with stride 1, dilation 1, one offset
group, padding k // 2 and no bias of its own, then an epilogue:
- x (B, 64, H, W): the input;
- offset (B, 2 k^2, H, W) float32: for tap t = (i, j), channel 2 t the
  row's offset and 2 t + 1 the column's;
- mask (B, k^2, H, W) float32: the modulator of each tap;
- weight (N, k, k, 64): the convolution's weight with the input channels
  last (`Conv2d.weight.permute(0, 2, 3, 1)`);
- bias (N,) float32 or None, added to the sum; `relu` then clamps at 0
  (models/birefnet.py folds the branch's BatchNorm into weight and bias);
- out: None, or a (B, >= N, H, W) tensor whose first N channels receive
  the result (a channel slice of the branch concatenation); returns the
  (B, N, H, W) result.

out[b, o, y, x] = sum_c sum_t W[o, i, j, c] * m[b, t, y, x] * S(x[b, c],
y - p + i + offset[b, 2 t, y, x], x - p + j + offset[b, 2 t + 1, y, x]),
where S is bilinear sampling as torchvision's: 0 where the position is at
or below -1 or at or above the size on either axis, else the four
neighbours, each neighbour outside the image counting 0. Positions and
bilinear weights are float32, and so is the sample times its modulator,
which is then rounded to x's type: that is the operand of the product
with the weight, which sums in float32.

A CPU tensor takes `deform_conv_plain`, that arithmetic in PyTorch
operations. A CUDA tensor launches the kernel, which takes x and weight
in bfloat16, 64 input and 256 output channels, x, offset and mask
channels-last and contiguous, weight (256, k, k, 64) contiguous, and an
`out` whose pixels are 16-byte aligned rows: anything else, a float32
x among it, raises. There is no fallback.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process; a deformable convolution is one
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

# the channels the kernel is built for: BiRefNet's ASPPDeformable(64)
# and its 256-wide branches
IN_CHANNELS = 64
OUT_CHANNELS = 256


def sample_taps(x: torch.Tensor, offset: torch.Tensor,
                mask: torch.Tensor, k: int, rows=None) -> torch.Tensor:
    """The modulated bilinear samples (B, C, k^2, R, W) in float32 of the
    output rows `rows` (a range; all by default), torchvision's
    arithmetic."""
    b, c, h, w = x.shape
    rows = range(h) if rows is None else rows
    r0, r1 = rows.start, rows.stop
    p = k // 2
    dev = x.device
    t = torch.arange(k * k, device=dev)
    ti, tj = (t // k).view(1, -1, 1, 1), (t % k).view(1, -1, 1, 1)
    oy = torch.arange(r0, r1, device=dev).view(1, 1, -1, 1)
    ox = torch.arange(w, device=dev).view(1, 1, 1, -1)
    off = offset[:, :, r0:r1].float()
    y = (oy - p + ti).float() + off[:, 0::2]           # (B, k^2, R, W)
    xx = (ox - p + tj).float() + off[:, 1::2]
    inside = (y > -1) & (y < h) & (xx > -1) & (xx < w)
    y0 = torch.floor(y)
    x0 = torch.floor(xx)
    ly, lx = y - y0, xx - x0
    hy, hx = 1 - ly, 1 - lx
    y0, x0 = y0.long(), x0.long()
    flat = x.float().reshape(b, c, h * w)
    shape = (b, c) + y.shape[1:]

    def corner(yy, xc):
        ok = inside & (yy >= 0) & (yy <= h - 1) & (xc >= 0) & (xc <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).reshape(b, 1, -1)
        v = torch.gather(flat, 2, idx.expand(b, c, -1)).reshape(shape)
        return torch.where(ok[:, None], v, 0.0)

    # a position outside gives four zero corners, so a zero sample
    val = ((hy * hx)[:, None] * corner(y0, x0)
           + (hy * lx)[:, None] * corner(y0, x0 + 1)
           + (ly * hx)[:, None] * corner(y0 + 1, x0)
           + (ly * lx)[:, None] * corner(y0 + 1, x0 + 1))
    return mask[:, None, :, r0:r1].float() * val


def deform_conv_plain(x: torch.Tensor, offset: torch.Tensor,
                      mask: torch.Tensor, weight: torch.Tensor,
                      bias=None, relu: bool = False, out=None,
                      rows: int = 64) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch operations, `rows` output rows
    at a time: the samples rounded to x's type, their product with the
    weight summed in float32, the bias and ReLU, the result in x's
    type."""
    b, c, h, w = x.shape
    n, k = weight.shape[0], weight.shape[1]
    wk = weight.float().reshape(n, k * k, c)
    res = torch.empty((b, n, h, w), dtype=x.dtype, device=x.device)
    for r0 in range(0, h, rows):
        rr = range(r0, min(h, r0 + rows))
        cols = sample_taps(x, offset, mask, k, rr).to(x.dtype).float()
        y = torch.einsum("bctrw,ntc->bnrw", cols, wk)
        if bias is not None:
            y = y + bias.float().view(1, -1, 1, 1)
        if relu:
            y = torch.clamp_min(y, 0.0)
        res[:, :, r0:rr.stop] = y.to(x.dtype)
    if out is None:
        return res
    out[:, :n] = res
    return out[:, :n]


def _check(x, offset, mask, weight, bias, out) -> int:
    """k of operands the kernel takes; raises on any other."""
    b, c, h, w = x.shape
    n, k = weight.shape[0], weight.shape[1]
    cl = torch.channels_last
    if c != IN_CHANNELS or n != OUT_CHANNELS or tuple(weight.shape) != (
            n, k, k, c) or k % 2 == 0:
        raise ValueError(f"the kernel takes {IN_CHANNELS} input and "
                         f"{OUT_CHANNELS} output channels and an odd k; got "
                         f"x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    if tuple(offset.shape) != (b, 2 * k * k, h, w) or \
            tuple(mask.shape) != (b, k * k, h, w):
        raise ValueError(f"offset {tuple(offset.shape)} and mask "
                         f"{tuple(mask.shape)} do not fit x {tuple(x.shape)} "
                         f"and k {k}")
    for t, dt in ((x, torch.bfloat16), (offset, torch.float32),
                  (mask, torch.float32), (weight, torch.bfloat16)):
        if t.dtype != dt or t.device != x.device:
            raise ValueError(f"the kernel takes x and weight in bfloat16, "
                             "offset and mask in float32, on one card; got "
                             f"{t.dtype} on {t.device}")
    for t in (x, offset, mask):
        if not t.is_contiguous(memory_format=cl):
            raise ValueError("x, offset and mask are read channels-last and "
                             "contiguous")
    if not weight.is_contiguous():
        raise ValueError("weight (N, k, k, C) is read contiguous")
    if bias is not None and (bias.dtype != torch.float32 or bias.numel() != n
                             or not bias.is_contiguous()
                             or bias.device != x.device):
        raise ValueError(f"bias is ({n},) float32 on x's card")
    if out is not None:
        ob, oc, oh, ow = out.shape
        sb, sc, sh, sw = out.stride()
        if (out.dtype != torch.bfloat16 or out.device != x.device
                or (ob, oh, ow) != (b, h, w) or oc < n or sc != 1
                or sh != w * sw or sb != h * sh or sw % 8
                or out.data_ptr() % 16):
            raise ValueError(
                "out is a (B, >= N, H, W) bfloat16 tensor of channels-last "
                "pixels (a pixel's channels contiguous, pixels a multiple of "
                f"8 elements apart, 16-byte aligned); got {tuple(out.shape)} "
                f"strides {out.stride()} {out.dtype}")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{b} x {h} x {w} is too large a launch")
    return k


def deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                weight: torch.Tensor, bias=None, relu: bool = False,
                out=None) -> torch.Tensor:
    """The kernel on a card, `deform_conv_plain` on the CPU."""
    global LAUNCHES
    if x.device.type == "cpu":
        return deform_conv_plain(x, offset, mask, weight, bias, relu, out)
    k = _check(x, offset, mask, weight, bias, out)
    b, _, h, w = x.shape
    n = weight.shape[0]
    if out is None:
        out = torch.empty((b, n, h, w), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(x.device):
        rc = _build.library().iseg_deform_conv(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), 0 if bias is None else bias.data_ptr(),
            int(relu), b, h, w, k, out.data_ptr(), out.stride(3), stream)
    _build.check(rc, "deform_conv")
    LAUNCHES += 1
    return out[:, :n]
