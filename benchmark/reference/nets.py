"""U^2-Netp and ISNet in plain PyTorch, eval only: the reference's CNN.

A frozen copy of the port's `models/u2net.py` (U^2-Net, Qin et al.,
Pattern Recognition 2020; DIS/ISNet, Qin et al., ECCV 2022) without its
training statistics and row blocks, with the module names of rembg's
checkpoints, which are the port's: one state dict loads into both.

`prec` sets the arithmetic of the encoder-decoder's convolutions:
- "f32": every operation in float32 (the reference; TF32 stays off);
- "fp8": the control, one step below the configuration's bfloat16: each
  REBNCONV's input and weight are rounded to float8 e4m3 with one scale a
  tensor (its largest magnitude maps to 448), the convolution runs on
  those values in bfloat16 with float32 accumulation, and the block
  keeps the port's bfloat16 bias, float32 BatchNorm and bfloat16 output.
  ISNet's conv_in takes the same rounding. The side and fuse
  convolutions are float32 in both, as in the port;
- "bf16": the configuration's own arithmetic, the port's bfloat16
  blocks without the float8 rounding: a witness, not the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor, returned in
    bfloat16."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / _FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return (q * scale).to(torch.bfloat16)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def upsample_like(x: torch.Tensor, ref_hw) -> torch.Tensor:
    """Bilinear resize to ref_hw (align_corners=False); a bfloat16 input
    one axis at a time in float32, rounded to bfloat16 after each axis,
    the axis whose contraction removes more elements first (the port's
    order)."""
    h, w = x.shape[2:]
    th, tw = int(ref_hw[0]), int(ref_hw[1])
    if (h, w) == (th, tw):
        return x
    if x.dtype != torch.bfloat16:
        return F.interpolate(x, size=(th, tw), mode="bilinear",
                             align_corners=False)
    n = x.numel()
    removed_h = n + h * th - n // h * th
    removed_w = n + w * tw - n // w * tw
    order = [(th, w), (th, tw)] if removed_h >= removed_w \
        else [(h, tw), (th, tw)]
    for hw in order:
        if tuple(x.shape[2:]) != hw:
            x = F.interpolate(x.to(torch.float32), size=hw, mode="bilinear",
                              align_corners=False).to(torch.bfloat16)
    return x


def _pool(x):
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class REBNCONV(nn.Module):
    """conv3x3 (dilation d) + BatchNorm (running statistics) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate,
                                 dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.prec = "f32"

    def forward(self, x):
        conv, bn = self.conv_s1, self.bn_s1
        d = conv.dilation[0]
        if self.prec != "f32":
            rnd = fp8_round if self.prec == "fp8" else _bf16
            y = F.conv2d(rnd(x), rnd(conv.weight), None, padding=d,
                         dilation=d)
            y = (y + conv.bias.to(torch.bfloat16)[:, None, None]) \
                .to(torch.float32)
        else:
            y = F.conv2d(x.to(torch.float32), conv.weight, None, padding=d,
                         dilation=d) + conv.bias[:, None, None]
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = (y - bn.running_mean[:, None, None]) * mul[:, None, None] \
            + bn.bias[:, None, None]
        y = y.relu()
        return y if self.prec == "f32" else y.to(torch.bfloat16)


class RSU(nn.Module):
    """Residual U-block of a given height (RSU-7 ... RSU-4)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        for i in range(2, height):
            setattr(self, f"rebnconv{i}", REBNCONV(mid_ch, mid_ch, 1))
        setattr(self, f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", REBNCONV(2 * mid_ch, mid_ch, 1))
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        enc = []
        hx = hxin
        for i in range(1, self.height):
            hx = getattr(self, f"rebnconv{i}")(hx)
            enc.append(hx)
            if i < self.height - 1:
                hx = _pool(hx)
        hx = getattr(self, f"rebnconv{self.height}")(hx)
        for i in range(self.height - 1, 0, -1):
            skip = enc[i - 1]
            hx = getattr(self, f"rebnconv{i}d")(
                torch.cat([upsample_like(hx, skip.shape[2:]), skip], 1))
        return hx + hxin


class RSU4F(nn.Module):
    """Dilated (pool-free) residual U-block."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch, 1)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        hx1 = self.rebnconv1(hxin)
        hx2 = self.rebnconv2(hx1)
        hx3 = self.rebnconv3(hx2)
        hx4 = self.rebnconv4(hx3)
        hx3d = self.rebnconv3d(torch.cat([hx4, hx3], 1))
        hx2d = self.rebnconv2d(torch.cat([hx3d, hx2], 1))
        hx1d = self.rebnconv1d(torch.cat([hx2d, hx1], 1))
        return hx1d + hxin


FULL = dict(cfg_enc=[(7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512)],
            f_mid=256, f_out=512,
            cfg_dec=[(4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64)])
SMALL = dict(cfg_enc=[(7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64)],
             f_mid=16, f_out=64,
             cfg_dec=[(4, 16, 64), (5, 16, 64), (6, 16, 64), (7, 16, 64)])


def _add_body(m: nn.Module, in_ch: int, out_ch: int, cfg_enc, f_mid: int,
              f_out: int, cfg_dec) -> None:
    chans = [in_ch] + [out for (_h, _m, out) in cfg_enc]
    for i, (height, mid, out) in enumerate(cfg_enc, start=1):
        setattr(m, f"stage{i}", RSU(height, chans[i - 1], mid, out))
    m.stage5 = RSU4F(chans[4], f_mid, f_out)
    m.stage6 = RSU4F(f_out, f_mid, f_out)
    m.stage5d = RSU4F(2 * f_out, f_mid, f_out)
    prev = f_out
    for i, (height, mid, out) in zip((4, 3, 2, 1), cfg_dec):
        setattr(m, f"stage{i}d", RSU(height, prev + chans[i], mid, out))
        prev = out
    side_in = [cfg_dec[3][2], cfg_dec[2][2], cfg_dec[1][2], cfg_dec[0][2],
               f_out, f_out]
    for i, c in enumerate(side_in, start=1):
        setattr(m, f"side{i}", nn.Conv2d(c, out_ch, 3, padding=1))


def _body(m: nn.Module, hx, ref_hw) -> list:
    """The six side logits d1..d6, float32, upsampled to ref_hw."""
    skips = []
    for i in range(1, 5):
        hx = getattr(m, f"stage{i}")(hx)
        skips.append(hx)
        hx = _pool(hx)
    hx5 = m.stage5(hx)
    hx6 = m.stage6(_pool(hx5))
    hx5d = m.stage5d(torch.cat([upsample_like(hx6, hx5.shape[2:]), hx5], 1))
    dec = [hx5d]
    hx = hx5d
    for i in (4, 3, 2, 1):
        skip = skips[i - 1]
        hx = getattr(m, f"stage{i}d")(
            torch.cat([upsample_like(hx, skip.shape[2:]), skip], 1))
        dec.append(hx)
    feats = (dec[4], dec[3], dec[2], dec[1], dec[0], hx6)
    sides = [getattr(m, f"side{i}") for i in range(1, 7)]
    return [upsample_like(side(f.to(torch.float32)), ref_hw)
            for side, f in zip(sides, feats)]


class U2NETP(nn.Module):
    """U^2-Netp: forward takes (B, 3, H, W) float32 and returns the fused
    saliency sigmoid(d0), (B, 1, H, W) float32."""

    def __init__(self):
        super().__init__()
        _add_body(self, 3, 1, **SMALL)
        self.outconv = nn.Conv2d(6, 1, 1)

    def forward(self, x):
        ds = _body(self, x, x.shape[2:])
        return self.outconv(torch.cat(ds, 1)).sigmoid()


class ISNet(nn.Module):
    """ISNet (isnet-general-use): a stride-2 3 x 3 conv_in (no BatchNorm,
    no ReLU) before the full U^2-Net's encoder-decoder; forward returns
    sigmoid(d1), (B, 1, H, W) float32, the head the pipeline reads."""

    def __init__(self):
        super().__init__()
        self.conv_in = nn.Conv2d(3, 64, 3, stride=2, padding=1)
        _add_body(self, 64, 1, **FULL)

    def forward(self, x):
        conv = self.conv_in
        prec = self.stage1.rebnconvin.prec
        if prec != "f32":
            rnd = fp8_round if prec == "fp8" else _bf16
            hxin = F.conv2d(rnd(x), rnd(conv.weight), None, stride=2,
                            padding=1)
            hxin = hxin + conv.bias.to(torch.bfloat16)[:, None, None]
        else:
            hxin = F.conv2d(x, conv.weight, None, stride=2, padding=1) \
                + conv.bias[:, None, None]
        return _body(self, hxin, x.shape[2:])[0].sigmoid()


ARCH = {"u2netp": U2NETP, "isnet": ISNet}


def build(arch: str, prec: str = "f32", device="meta") -> nn.Module:
    """The network of `arch` ("u2netp" or "isnet") on `device` in eval
    mode, its convolutions at `prec` ("f32", "bf16" or "fp8")."""
    with torch.device(device):
        m = ARCH[arch]()
    set_prec(m, prec)
    return m.eval()


def set_prec(m: nn.Module, prec: str) -> None:
    if prec not in ("f32", "bf16", "fp8"):
        raise ValueError(f"unknown precision {prec!r}")
    for mod in m.modules():
        if isinstance(mod, REBNCONV):
            mod.prec = prec
