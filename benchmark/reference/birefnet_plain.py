"""BiRefNet with its Swin-L backbone (Zheng et al. 2024, CAAI AIR;
ZhengPeng7/BiRefNet with `bb = swin_v1_l`, rembg's `birefnet-general`)
in plain PyTorch: the reference the port's BiRefNet is held to.

Written from the arithmetic of `models/birefnet.py`,
`models/backbones/swin_v1.py`, `models/modules/decoder_blocks.py`,
`aspp.py`, `deform_conv.py` (torchvision's `deform_conv2d`) and
`lateral_blocks.py`, with their module names, so that one state dict
loads into this and into the port; it imports nothing of the port or of
JAX. Eval only, float32, one frame at a time: every window attention
materialised (softmax of q k^T times the scale plus the table's bias and,
in a shifted block, the -100 mask, then times V); each deformable
convolution an explicit bilinear gather of its taps from the input
padded by one zero pixel, in blocks of output rows, then a product with
the weight; `F.interpolate(..., align_corners=True)` for every resize.

Departures from the official code: none intended in the arithmetic. The
weights are whatever the caller loads (the benchmark seeds them:
yardstick/birefnet_weights.py). Dropout and drop-path are eval's
identities; the training heads' parameters are kept for loading.

`prec` sets the arithmetic of every linear and convolution but conv_out1
(which the configuration keeps in float32), the deformable ones' sampled
operand and weight included:
- "f32": float32 operands (the reference; TF32 stays off);
- "fp8": the control, below the configuration's bfloat16: the input and
  the weight rounded to float8 e4m3 with one scale a tensor (its largest
  magnitude maps to 448), as `nets.py`'s control rounds convolutions,
  then computed in float32;
- "bf16": the configuration's operands, input, weight and bias rounded
  to bfloat16 and computed in float32: a witness, not the reference.

`faults` (a set; the tests' switches, each a fault the comparison must
catch): "table" zeroes the relative-position tables' bias, "shift" drops
the shift mask, "offsets" zeroes the deformable offsets, "modulator"
takes 1 in place of 2 sigmoid, "half_scale" replaces the 512 x 512
backbone's outputs by zeros, "align_corners" resizes with
align_corners=False.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_FP8_MAX = 448.0

# swin_v1_l in BiRefNet's config.py
WIDTHS = dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
              window_size=12, mlp_ratio=4.0, patch_size=4)
INTER, BRANCH, GATE = 64, 256, 16


def widths(**over) -> dict:
    w = {**WIDTHS, **over}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in w.items()}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _Prec:
    """The switches every module of one network shares."""

    def __init__(self, prec: str = "f32", faults=()):
        if prec not in ("f32", "bf16", "fp8"):
            raise ValueError(f"prec {prec!r}")
        self.prec, self.faults = prec, frozenset(faults)

    def operands(self, x, w, b=None):
        if self.prec == "fp8":
            return fp8_round(x), fp8_round(w), b
        if self.prec == "bf16":
            return bf16_round(x), bf16_round(w), \
                None if b is None else bf16_round(b)
        return x, w, b

    def resize(self, x, size):
        size = tuple(int(s) for s in size)
        if tuple(x.shape[2:]) == size:
            return x
        return F.interpolate(x, size=size, mode="bilinear",
                             align_corners="align_corners" not in self.faults)


class Lin(nn.Linear):
    ctx: _Prec = None

    def forward(self, x):
        return F.linear(*self.ctx.operands(x, self.weight, self.bias))


class Conv(nn.Conv2d):
    ctx: _Prec = None
    exact = False  # conv_out1: float32 in the configuration

    def forward(self, x):
        if self.exact:
            return self._conv_forward(x, self.weight, self.bias)
        return self._conv_forward(*self.ctx.operands(x, self.weight,
                                                     self.bias))


# ------------------------------------------------------------- Swin-L

def position_index(ws: int) -> torch.Tensor:
    """WindowAttention's `relative_position_index`: for positions i, j of
    a ws x ws window, (yi - yj + ws - 1) (2 ws - 1) + xi - xj + ws - 1."""
    yy, xx = torch.meshgrid(torch.arange(ws), torch.arange(ws),
                            indexing="ij")
    y, x = yy.flatten(), xx.flatten()
    return (y[:, None] - y[None, :] + ws - 1) * (2 * ws - 1) \
        + x[:, None] - x[None, :] + ws - 1


class WindowAttention(nn.Module):
    def __init__(self, dim, ws, heads):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("relative_position_index", position_index(ws))
        self.qkv = Lin(dim, 3 * dim)
        self.proj = Lin(dim, dim)

    def forward(self, x, mask):
        """x (nW, n, C) windows of one frame; mask (nW, n, n) or None."""
        nw, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(nw, n, 3, self.heads, hd) \
            .permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1) \
            .permute(2, 0, 1)
        if "table" in self.proj.ctx.faults:
            bias = torch.zeros_like(bias)
        attn = attn + bias[None]
        if mask is not None:
            attn = attn + mask[:, None]
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(nw, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = Lin(dim, hidden), Lin(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift, mlp_ratio):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, h, w, mask):
        """x (1, h w, C), swin_v1.SwinTransformerBlock.forward."""
        c, ws, s = x.shape[2], self.ws, self.shift
        shortcut = x
        x = self.norm1(x).view(1, h, w, c)
        pr, pb = (ws - w % ws) % ws, (ws - h % ws) % ws
        x = F.pad(x, (0, 0, 0, pr, 0, pb))
        hp, wp = h + pb, w + pr
        if s > 0:
            x = torch.roll(x, (-s, -s), (1, 2))
        win = x.view(1, hp // ws, ws, wp // ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        use = mask if s > 0 and "shift" not in self.attn.proj.ctx.faults \
            else None
        win = self.attn(win, use)
        x = win.view(1, hp // ws, wp // ws, ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(1, hp, wp, c)
        if s > 0:
            x = torch.roll(x, (s, s), (1, 2))
        x = x[:, :h, :w].reshape(1, h * w, c)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.reduction = Lin(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x, h, w):
        c = x.shape[2]
        x = x.view(1, h, w, c)
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1).view(1, -1, 4 * c)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, heads, ws, mlp_ratio, down):
        super().__init__()
        self.ws = ws
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2,
                                 mlp_ratio) for i in range(depth))
        self.downsample = PatchMerging(dim) if down else None

    def forward(self, x, h, w):
        ws, s = self.ws, self.ws // 2
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        img = torch.zeros((1, hp, wp, 1), device=x.device)
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
            for wsl in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
                img[:, hs, wsl, :] = cnt
                cnt += 1
        mw = img.view(1, hp // ws, ws, wp // ws, ws, 1).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
        mask = mw.unsqueeze(1) - mw.unsqueeze(2)
        mask = mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)
        for blk in self.blocks:
            x = blk(x, h, w, mask)
        if self.downsample is None:
            return x, x, h, w
        return x, self.downsample(x, h, w), (h + 1) // 2, (w + 1) // 2


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = Conv(3, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(x.flatten(2).transpose(1, 2)), x.shape[2], x.shape[3]


class SwinTransformer(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.patch_embed = PatchEmbed(w["patch_size"], w["embed_dim"])
        n = len(w["depths"])
        dims = [w["embed_dim"] * 2 ** i for i in range(n)]
        self.dims = dims
        self.layers = nn.ModuleList(
            BasicLayer(dims[i], w["depths"][i], w["num_heads"][i],
                       w["window_size"], w["mlp_ratio"], i < n - 1)
            for i in range(n))
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", nn.LayerNorm(d))

    def forward(self, x):
        x, h, w = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            out, x, h2, w2 = layer(x, h, w)
            o = getattr(self, f"norm{i}")(out)
            outs.append(o.view(1, h, w, self.dims[i]).permute(0, 3, 1, 2))
            h, w = h2, w2
        return outs


# ------------------------------------------------------------- decoder

def deform_conv2d(ctx, x, offset, mask, weight, rows=16):
    """torchvision's deform_conv2d (stride 1, dilation 1, one offset
    group, padding k // 2, no bias) on one frame: each tap's position in
    float32, its bilinear sample from x padded by one zero pixel (a
    neighbour outside the image reads 0), zero where the position is at
    or below -1 or at or above the size, times the modulator; then the
    product with the weight."""
    _, c, h, w = x.shape
    n, _, k, _ = weight.shape
    p = k // 2
    xp = F.pad(x[0], (1, 1, 1, 1)).reshape(c, -1)     # (C, (h+2)(w+2))
    wide = w + 2
    wmat = weight.reshape(n, c * k * k)
    out = x.new_empty((1, n, h, w))
    ti = torch.arange(k * k, device=x.device) // k
    tj = torch.arange(k * k, device=x.device) % k
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        yy = torch.arange(r0, r1, device=x.device)[None, :, None]
        xx = torch.arange(w, device=x.device)[None, None, :]
        py = (yy - p + ti[:, None, None]).to(torch.float32) \
            + offset[0, 0::2, r0:r1]
        px = (xx - p + tj[:, None, None]).to(torch.float32) \
            + offset[0, 1::2, r0:r1]
        inside = (py > -1) & (py < h) & (px > -1) & (px < w)
        fy, fx = torch.floor(py), torch.floor(px)
        ly, lx = py - fy, px - fx
        hy, hx = 1 - ly, 1 - lx
        # padded coordinates of the top-left neighbour, kept in range
        iy = (fy.long() + 1).clamp(0, h)
        ix = (fx.long() + 1).clamp(0, w)

        def at(dy, dx):
            return xp[:, ((iy + dy) * wide + ix + dx).reshape(-1)] \
                .view(c, *iy.shape)

        val = (hy * hx) * at(0, 0) + (hy * lx) * at(0, 1) \
            + (ly * hx) * at(1, 0) + (ly * lx) * at(1, 1)
        val = torch.where(inside, val, 0.0) * mask[0, :, r0:r1]
        cols = val.reshape(c * k * k, -1)               # (C k^2, R w)
        a, b, _ = ctx.operands(cols, wmat)
        out[0, :, r0:r1] = (b @ a).view(n, r1 - r0, w)
    return out


class DeformableConv2d(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.offset_conv = Conv(cin, 2 * k * k, k, padding=k // 2)
        self.modulator_conv = Conv(cin, k * k, k, padding=k // 2)
        self.regular_conv = Conv(cin, cout, k, padding=k // 2, bias=False)

    def forward(self, x):
        ctx = self.regular_conv.ctx
        offset = self.offset_conv(x)
        if "offsets" in ctx.faults:
            offset = torch.zeros_like(offset)
        m = self.modulator_conv(x)
        m = torch.ones_like(m) if "modulator" in ctx.faults \
            else 2.0 * torch.sigmoid(m)
        return deform_conv2d(ctx, x, offset, m, self.regular_conv.weight)


class _ASPPModuleDeformable(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.atrous_conv = DeformableConv2d(cin, cout, k)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPPDeformable(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.aspp1 = _ASPPModuleDeformable(cin, BRANCH, 1)
        self.aspp_deforms = nn.ModuleList(
            _ASPPModuleDeformable(cin, BRANCH, k) for k in (1, 3, 7))
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)), Conv(cin, BRANCH, 1, bias=False),
            nn.BatchNorm2d(BRANCH), nn.ReLU())
        self.conv1 = Conv(BRANCH * 5, cin, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cin)

    def forward(self, x):
        x1 = self.aspp1(x)
        rest = [m(x) for m in self.aspp_deforms]
        x5 = self.conv1.ctx.resize(self.global_avg_pool(x), x1.shape[2:])
        x = torch.cat((x1, *rest, x5), 1)
        return F.relu(self.bn1(self.conv1(x)))


class BasicDecBlk(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv_in = Conv(cin, INTER, 3, padding=1)
        self.bn_in = nn.BatchNorm2d(INTER)
        self.dec_att = ASPPDeformable(INTER)
        self.conv_out = Conv(INTER, cout, 3, padding=1)
        self.bn_out = nn.BatchNorm2d(cout)

    def forward(self, x):
        x = F.relu(self.bn_in(self.conv_in(x)))
        return self.bn_out(self.conv_out(self.dec_att(x)))


class SimpleConvs(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, INTER, 3, padding=1)
        self.conv_out = Conv(INTER, cout, 3, padding=1)

    def forward(self, x):
        return self.conv_out(self.conv1(x))


class BasicLatBlk(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


def get_patches_batch(x, p):
    """Decoder.get_patches_batch: x cut into patches of p's size, stacked
    on the channels column by column, each column's patches from the
    top."""
    hs, wsz = p.shape[2:]
    out = []
    for i in range(x.shape[0]):
        parts = []
        for col in torch.split(x[i], wsz, dim=-1):
            parts += [q.unsqueeze(0) for q in torch.split(col, hs, dim=-2)]
        out.append(torch.cat(parts, 1))
    return torch.cat(out, 0)


class Decoder(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.ipt_blk5 = SimpleConvs(2 ** 10 * 3, ch[0] // 8)
        self.ipt_blk4 = SimpleConvs(2 ** 8 * 3, ch[0] // 8)
        self.ipt_blk3 = SimpleConvs(2 ** 6 * 3, ch[1] // 8)
        self.ipt_blk2 = SimpleConvs(2 ** 4 * 3, ch[2] // 8)
        self.ipt_blk1 = SimpleConvs(2 ** 0 * 3, ch[3] // 8)
        self.decoder_block4 = BasicDecBlk(ch[0] + ch[0] // 8, ch[1])
        self.decoder_block3 = BasicDecBlk(ch[1] + ch[0] // 8, ch[2])
        self.decoder_block2 = BasicDecBlk(ch[2] + ch[1] // 8, ch[3])
        self.decoder_block1 = BasicDecBlk(ch[3] + ch[2] // 8, ch[3] // 2)
        self.conv_out1 = nn.Sequential(Conv(ch[3] // 2 + ch[3] // 8, 1, 1))
        self.conv_out1[0].exact = True
        self.lateral_block4 = BasicLatBlk(ch[1], ch[1])
        self.lateral_block3 = BasicLatBlk(ch[2], ch[2])
        self.lateral_block2 = BasicLatBlk(ch[3], ch[3])
        self.conv_ms_spvn_4 = Conv(ch[1], 1, 1)
        self.conv_ms_spvn_3 = Conv(ch[2], 1, 1)
        self.conv_ms_spvn_2 = Conv(ch[3], 1, 1)
        for i, c in ((4, ch[1]), (3, ch[2]), (2, ch[3])):
            self.add_module(f"gdt_convs_{i}", nn.Sequential(
                Conv(c, GATE, 3, padding=1), nn.BatchNorm2d(GATE), nn.ReLU()))
            self.add_module(f"gdt_convs_pred_{i}",
                            nn.Sequential(Conv(GATE, 1, 1)))
            self.add_module(f"gdt_convs_attn_{i}",
                            nn.Sequential(Conv(GATE, 1, 1)))

    def forward(self, x, x1, x2, x3, x4):
        rs = self.conv_out1[0].ctx.resize

        def ipt(blk, like):
            return blk(rs(get_patches_batch(x, like), like.shape[2:]))

        def gated(p, i):
            g = getattr(self, f"gdt_convs_attn_{i}")(
                getattr(self, f"gdt_convs_{i}")(p))
            return p * g.sigmoid()

        x4 = torch.cat((x4, ipt(self.ipt_blk5, x4)), 1)
        p4 = gated(self.decoder_block4(x4), 4)
        _p3 = rs(p4, x3.shape[2:]) + self.lateral_block4(x3)
        _p3 = torch.cat((_p3, ipt(self.ipt_blk4, _p3)), 1)
        p3 = gated(self.decoder_block3(_p3), 3)
        _p2 = rs(p3, x2.shape[2:]) + self.lateral_block3(x2)
        _p2 = torch.cat((_p2, ipt(self.ipt_blk3, _p2)), 1)
        p2 = gated(self.decoder_block2(_p2), 2)
        _p1 = rs(p2, x1.shape[2:]) + self.lateral_block2(x1)
        _p1 = torch.cat((_p1, ipt(self.ipt_blk2, _p1)), 1)
        _p1 = rs(self.decoder_block1(_p1), x.shape[2:])
        _p1 = torch.cat((_p1, ipt(self.ipt_blk1, _p1)), 1)
        return self.conv_out1(_p1)


class BiRefNetPlain(nn.Module):
    """`bb`, `squeeze_module`, `decoder`; forward (1, 3, H, W) normalised
    -> logits (1, 1, H, W)."""

    def __init__(self, prec: str = "f32", faults=(), **over):
        super().__init__()
        w = widths(**over)
        n = len(w["depths"])
        dims = [w["embed_dim"] * 2 ** i for i in range(n)]
        ch = [2 * d for d in reversed(dims)]
        self.bb = SwinTransformer(w)
        self.squeeze_module = nn.Sequential(
            BasicDecBlk(ch[0] + sum(ch[1:]), ch[0]))
        self.decoder = Decoder(ch)
        self.set(prec, faults)
        self.eval()

    def set(self, prec: str = "f32", faults=()) -> None:
        ctx = _Prec(prec, faults)
        self.ctx = ctx
        for m in self.modules():
            if isinstance(m, (Lin, Conv)):
                m.ctx = ctx

    def forward(self, x):
        rs = self.ctx.resize
        h, w = x.shape[2:]
        x1, x2, x3, x4 = self.bb(x)
        y1, y2, y3, y4 = self.bb(rs(x, (h // 2, w // 2)))
        if "half_scale" in self.ctx.faults:
            y1, y2, y3, y4 = (torch.zeros_like(t) for t in (y1, y2, y3, y4))
        x1 = torch.cat([x1, rs(y1, x1.shape[2:])], 1)
        x2 = torch.cat([x2, rs(y2, x2.shape[2:])], 1)
        x3 = torch.cat([x3, rs(y3, x3.shape[2:])], 1)
        x4 = torch.cat([x4, rs(y4, x4.shape[2:])], 1)
        g = x4.shape[2:]
        x4 = torch.cat((rs(x1, g), rs(x2, g), rs(x3, g), x4), 1)
        x4 = self.squeeze_module(x4)
        return self.decoder(x, x1, x2, x3, x4)
