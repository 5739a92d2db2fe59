"""U^2-Net (full and U2NETP) and ISNet as PyTorch modules, NCHW.

Counterpart of image_segmenter_tpu/models/u2net.py (Qin et al., Pattern
Recognition 2020; DIS/ISNet, Qin et al., ECCV 2022). Module names follow
rembg's checkpoints (stage1.rebnconvin.conv_s1.weight, ..., conv_in), the
names models/convert.py maps the JAX package's Flax variables onto and
models/onnx_import.py reads from a rembg `.onnx`.

Numerics follow the Flax modules. With `half=True` each REBNCONV runs its
convolution in bfloat16 (the card accumulates in float32), adds the bias
in bfloat16, normalises in float32, applies ReLU and casts back to
bfloat16. ISNet's conv_in runs in bfloat16 too, bias added in bfloat16.
The side convolutions and the fuse conv run in float32, and the side
outputs are float32 before their upsample. "float32" is the parameters'
own type, which they always have in use: a module cast by `.double()`
computes in float64 throughout.

`train=True` (the `train` argument of the Flax modules; `nn.Module.training`
does not switch it) normalises with the batch's statistics as Flax's
BatchNorm does and updates the running buffers (pipeline/train.py);
within `batch_norm_sum` (the data-parallel step) the statistics are the
whole batch's, summed over the processes.

The forward takes a tensor or a `parallel/spatial.Rows`, the activation
split into row blocks over the slots of a mesh (the training step's
space axis). The five operations whose result depends on more than a
pixel's own channels go through helpers that take either: the
convolution (`_conv`), the training statistics (`_moments`), the pool
(`_maxpool2`), the upsample (`_upsample`) and the channel concatenation
(`_cat`); the rest is elementwise, which `Rows` does block by block. On a
tensor every helper is the operation it was, with its bits.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_segmenter_tpu_torch.parallel import spatial as S


def _bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def upsample_like(x: torch.Tensor, ref_hw) -> torch.Tensor:
    """Bilinear resize to ref spatial size (align_corners=False). The
    network only ever upsamples, where this equals jax.image.resize.

    A bfloat16 input is resized one axis at a time, in float32, rounding
    to bfloat16 after each axis: jax.image.resize is an einsum of one
    weight matrix per axis, and XLA rounds its intermediate. Its
    contraction order is opt_einsum's greedy choice: first the axis whose
    contraction removes the most elements (the larger weight matrix on
    equal intermediates), rows first on a tie.
    """
    h, w = x.shape[2:]
    th, tw = int(ref_hw[0]), int(ref_hw[1])
    if (h, w) == (th, tw):
        return x
    if x.dtype != torch.bfloat16:
        return _bilinear(x, (th, tw))
    n = x.numel()
    removed_h = n + h * th - n // h * th
    removed_w = n + w * tw - n // w * tw
    order = [(th, w), (th, tw)] if removed_h >= removed_w else [(h, tw), (th, tw)]
    for hw in order:
        if tuple(x.shape[2:]) != hw:
            x = _bilinear(x.to(torch.float32), hw).to(torch.bfloat16)
    return x


def _upsample(x, ref):
    """`x` resized to the size of `ref` (a tensor or row blocks of the
    level to resize to)."""
    if isinstance(x, S.Rows):
        return S.upsample(x, ref)
    return upsample_like(x, ref.shape[2:])


def _maxpool2(x):
    if isinstance(x, S.Rows):
        return S.maxpool2(x)
    # the JAX package pads (0, 1) on odd sizes: ceil_mode
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _conv(x, weight: torch.Tensor, bias=None, dilation: int = 1):
    """A stride-1 convolution, zero padding dilation * (k // 2) (the
    network's 3 x 3 and 1 x 1 convolutions)."""
    if isinstance(x, S.Rows):
        return S.conv2d(x, weight, bias, dilation)
    pad = dilation * (weight.shape[-1] // 2)
    return F.conv2d(x, weight, bias, padding=pad, dilation=dilation)


def _cat(*xs):
    """Channel concatenation."""
    if isinstance(xs[0], S.Rows):
        return S.cat(xs)
    return torch.cat(xs, 1)


# A differentiable sum over the processes of a data-parallel training step
# (pipeline/train.loss_and_grads sets it for a shard's forward): the
# training BatchNorms then normalise with the whole batch's statistics.
_BN_SUM = contextvars.ContextVar("bn_sum", default=None)


@contextlib.contextmanager
def batch_norm_sum(fn):
    """Within the block (in this thread or task), every training BatchNorm
    sums its per-channel sum(y), sum(y * y) and count with `fn` before it
    forms the mean and Flax's biased variance E[y^2] - E[y]^2."""
    token = _BN_SUM.set(fn)
    try:
        yield
    finally:
        _BN_SUM.reset(token)


def _moments(y):
    """Flax's training statistics of y over (N, H, W): float32 mean and
    the fast biased variance E[y^2] - E[y]^2 clipped at 0. Within
    `batch_norm_sum`, and on row blocks, they are formed from per-channel
    sum(y), sum(y * y) and the count, added over the blocks on the first
    slot and then summed by `batch_norm_sum`'s fn."""
    bn_sum = _BN_SUM.get()
    if bn_sum is None and not isinstance(y, S.Rows):
        mean = y.mean((0, 2, 3))
        return mean, torch.clamp((y * y).mean((0, 2, 3)) - mean * mean,
                                 min=0.0)
    sums = S.channel_sums(y)
    if bn_sum is not None:
        sums = bn_sum(sums)
    c = (sums.shape[0] - 1) // 2
    mean = sums[:c] / sums[2 * c]
    return mean, torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean,
                             min=0.0)


class REBNCONV(nn.Module):
    """conv3x3(dilation d) + BN + ReLU — the U^2-Net building block."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1,
                 half: bool = False):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate,
                                 dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.bf16 = half

    @property
    def dtype(self) -> torch.dtype:
        """The convolution's type: bfloat16 with `half`, else the
        parameters' own."""
        return torch.bfloat16 if self.bf16 else self.conv_s1.weight.dtype

    def forward(self, x, train: bool = False):
        conv, bn = self.conv_s1, self.bn_s1
        y = _conv(x.to(self.dtype), conv.weight.to(self.dtype), None,
                  conv.dilation[0])
        y = (y + conv.bias.to(self.dtype)[:, None, None]).to(bn.weight.dtype)
        if train:
            # Flax's BatchNorm: float32 statistics over (N, H, W), the fast
            # biased variance E[y^2] - E[y]^2 clipped at 0, and the running
            # buffers moved by momentum 0.9 with that biased variance
            # (BatchNorm2d would move them with the unbiased one)
            mean, var = _moments(y)
            with torch.no_grad():
                bn.running_mean.copy_(0.9 * bn.running_mean
                                      + (1.0 - 0.9) * mean)
                bn.running_var.copy_(0.9 * bn.running_var + (1.0 - 0.9) * var)
        else:
            mean, var = bn.running_mean, bn.running_var
        # BatchNorm in float32, in Flax's order of operations
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        y = (y - mean[:, None, None]) * mul[:, None, None] \
            + bn.bias[:, None, None]
        return y.relu().to(self.dtype)


class RSU(nn.Module):
    """Residual U-block of a given height (RSU-7 ... RSU-4)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int,
                 half: bool = False):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1, half)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1, half)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch, 1, half))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2, half))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d",
                    REBNCONV(2 * mid_ch, mid_ch, 1, half))
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1, half)

    def forward(self, x, train: bool = False):
        hxin = self.rebnconvin(x, train)
        # encoder
        enc = []
        hx = hxin
        for i in range(1, self.height):
            hx = getattr(self, f"rebnconv{i}")(hx, train)
            enc.append(hx)
            if i < self.height - 1:
                hx = _maxpool2(hx)
        # bottom (dilated)
        hx = getattr(self, f"rebnconv{self.height}")(hx, train)
        # decoder
        for i in range(self.height - 1, 0, -1):
            skip = enc[i - 1]
            hx = getattr(self, f"rebnconv{i}d")(
                _cat(_upsample(hx, skip), skip), train)
        return hx + hxin


class RSU4F(nn.Module):
    """Dilated (pool-free) residual U-block."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int,
                 half: bool = False):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1, half)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1, half)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2, half)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4, half)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8, half)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4, half)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2, half)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1, half)

    def forward(self, x, train: bool = False):
        hxin = self.rebnconvin(x, train)
        hx1 = self.rebnconv1(hxin, train)
        hx2 = self.rebnconv2(hx1, train)
        hx3 = self.rebnconv3(hx2, train)
        hx4 = self.rebnconv4(hx3, train)
        hx3d = self.rebnconv3d(_cat(hx4, hx3), train)
        hx2d = self.rebnconv2d(_cat(hx3d, hx2), train)
        hx1d = self.rebnconv1d(_cat(hx2d, hx1), train)
        return hx1d + hxin


_FULL = dict(cfg_enc=[(7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512)],
             f_mid=256, f_out=512,
             cfg_dec=[(4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64)])
_SMALL = dict(cfg_enc=[(7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64)],
              f_mid=16, f_out=64,  # U2NETP: every stage mid=16, out=64
              cfg_dec=[(4, 16, 64), (5, 16, 64), (6, 16, 64), (7, 16, 64)])


def _add_body(m: nn.Module, in_ch: int, out_ch: int, half: bool, cfg_enc,
              f_mid: int, f_out: int, cfg_dec) -> None:
    """Register the encoder stages 1-6, the decoder stages 5d-1d and the
    six side heads of the U^2-Net family on `m`."""
    chans = [in_ch] + [out for (_h, _m, out) in cfg_enc]
    for i, (height, mid, out) in enumerate(cfg_enc, start=1):
        setattr(m, f"stage{i}", RSU(height, chans[i - 1], mid, out, half))
    m.stage5 = RSU4F(chans[4], f_mid, f_out, half)
    m.stage6 = RSU4F(f_out, f_mid, f_out, half)
    m.stage5d = RSU4F(2 * f_out, f_mid, f_out, half)
    # decoder stage i takes [upsampled previous decoder, skip i]
    prev = f_out
    for i, (height, mid, out) in zip((4, 3, 2, 1), cfg_dec):
        setattr(m, f"stage{i}d", RSU(height, prev + chans[i], mid, out, half))
        prev = out
    side_in = [cfg_dec[3][2], cfg_dec[2][2], cfg_dec[1][2], cfg_dec[0][2],
               f_out, f_out]
    for i, c in enumerate(side_in, start=1):
        setattr(m, f"side{i}", nn.Conv2d(c, out_ch, 3, padding=1))


def _body(m: nn.Module, hx, ref, train: bool = False) -> list:
    """The encoder-decoder from `hx`: the six side logits d1..d6, float32,
    upsampled to the size of `ref` (the network's input)."""
    skips = []
    for i in range(1, 5):
        hx = getattr(m, f"stage{i}")(hx, train)
        skips.append(hx)
        hx = _maxpool2(hx)
    hx5 = m.stage5(hx, train)
    hx6 = m.stage6(_maxpool2(hx5), train)

    # decoder
    hx5d = m.stage5d(_cat(_upsample(hx6, hx5), hx5), train)
    dec = [hx5d]
    hx = hx5d
    for i in (4, 3, 2, 1):
        skip = skips[i - 1]
        hx = getattr(m, f"stage{i}d")(_cat(_upsample(hx, skip), skip), train)
        dec.append(hx)

    # side outputs (d1..d6) in float32
    feats = (dec[4], dec[3], dec[2], dec[1], dec[0], hx6)
    sides = [getattr(m, f"side{i}") for i in range(1, 7)]
    return [_upsample(_conv(f.to(side.weight.dtype), side.weight, side.bias),
                      ref) for side, f in zip(sides, feats)]


class U2NET(nn.Module):
    """Full U^2-Net (or U2NETP with small=True). out_ch=1 for saliency.

    forward takes (B, 3, H, W) float32 and returns [sigmoid(d0), ...,
    sigmoid(d6)], each (B, out_ch, H, W) float32; with train=True the
    BatchNorms use and record the batch's statistics. Given row blocks
    (`parallel/spatial.Rows`), it returns row blocks of the same split.
    """

    def __init__(self, out_ch: int = 1, small: bool = False,
                 half: bool = False):
        super().__init__()
        _add_body(self, 3, out_ch, half, **(_SMALL if small else _FULL))
        self.outconv = nn.Conv2d(6 * out_ch, out_ch, 1)

    def forward(self, x, train: bool = False):
        ds = _body(self, x, x, train)
        d0 = _conv(_cat(*ds), self.outconv.weight, self.outconv.bias)
        return [d.sigmoid() for d in (d0, *ds)]


class ISNet(nn.Module):
    """ISNet / DIS (isnet-general-use, isnet-anime): a stride-2 3 x 3
    `conv_in` (no BatchNorm, no ReLU in the public release) in front of
    the full U^2-Net's encoder-decoder, and no fuse conv.

    forward takes (B, 3, H, W) float32 and returns [sigmoid(d1), ...,
    sigmoid(d6)], each (B, out_ch, H, W) float32: the side heads are
    upsampled to the input's size, past the stride of conv_in.
    """

    def __init__(self, out_ch: int = 1, half: bool = False):
        super().__init__()
        self.conv_in = nn.Conv2d(3, 64, 3, stride=2, padding=1)
        self.dtype = torch.bfloat16 if half else torch.float32
        _add_body(self, 64, out_ch, half, **_FULL)

    def forward(self, x):
        conv = self.conv_in
        hxin = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), None,
                        stride=2, padding=1)
        hxin = hxin + conv.bias.to(self.dtype)[:, None, None]
        return [torch.sigmoid(d) for d in _body(self, hxin, x)]
