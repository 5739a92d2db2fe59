"""BiRefNet (Zheng et al. 2024, "Bilateral Reference for High-Resolution
Dichotomous Image Segmentation", CAAI AIR) with its Swin-L backbone, as
rembg's `birefnet-general` session runs it, as PyTorch modules.

The arithmetic is that of ZhengPeng7/BiRefNet (`models/birefnet.py`,
`models/backbones/swin_v1.py`, `models/modules/decoder_blocks.py`,
`aspp.py`, `deform_conv.py`, `lateral_blocks.py`, `config.py` with
`bb = swin_v1_l`), eval only, and the module names are its own (`bb.*`,
`squeeze_module.0.*`, `decoder.*`), so that the published state dict
(`BiRefNet-general-epoch_244.pth`) loads strictly. `SWIN_L` holds its
widths.

Backbone: Swin-L (the detection variant, which pads): a 4 x 4 patch
embedding, four stages of 2, 2, 18 and 2 blocks of widths 192, 384, 768
and 1536 with 6, 12, 24 and 48 heads of 32, patch merging between them.
A block attends within 12 x 12 windows of the token grid zero-padded
(after its first LayerNorm) to a multiple of 12; every second block
rolls the grid by 6 first and masks with -100 the pairs of a window that
come from different regions of the roll; every block adds a bias
gathered from its (23^2, heads) relative-position table. The backbone
runs on the input and again on a bilinear half-size copy, and the two
outputs are concatenated at each of the four scales.

Decoder: the squeeze block on the four scales' context at 1/32, then
four decoder blocks up to 1/4, each fed the image's own pixels cut into
patches at its grid (`dec_ipt_split`) and a lateral 1 x 1 of the
encoder's scale; gradient-attention gates after the lower three. A block
is conv 3 x 3, BatchNorm, ReLU, an ASPP whose four branches are
modulated deformable convolutions (kernels 1, 1, 3, 7; offsets and
modulators predicted by convolutions of the branch's input) beside a
pooled branch, then conv 3 x 3 and BatchNorm. The training heads
(`conv_ms_spvn_*`, `gdt_convs_pred_*`) are kept for loading and not run.
The forward returns [logits (B, 1, H, W)].

Departures from the official code, all of the grouping of operations,
none of what is computed: conv_out1, the last 1 x 1 convolution over the
concatenation of the decoder's output resized to the input's size and
the input's own branch, is applied to the decoder's output before the
bilinear resize (the two are linear, so they commute), which keeps a
(B, 192, H, W) tensor out of memory; the bilinear resize of a patch
tensor to its own size, an identity, is skipped.

Precision (`half`, the Session's switch): with `half=False` everything
is float32, the official arithmetic op for op; that network runs on the
CPU only, since on a card each deformable convolution is the kernel,
which takes bfloat16 and raises on float32. With `half=True`:
- bfloat16 operands with float32 accumulation: the patch embedding,
  every linear, every convolution of the decoder (the offset and
  modulator convolutions too) and the deformable convolutions' sampled
  operand and weights (kernels/deform_conv.py); the decoder's
  activations are kept in bfloat16 between operations, channels-last;
  each BatchNorm is folded into the convolution before it;
- float32: the residual stream, the LayerNorms, the softmax statistics,
  the offsets and modulators after their convolutions (2 sigmoid in
  float32), the sampling positions and bilinear weights, conv_out1's
  products and sums, and the sigmoid gates;
- window attention through kernels/swin_attention: the qkv projection
  runs on the block's unpadded, unrolled grid, and on a card one kernel
  a block reads its windows, forms the gathered table bias plus the
  shift mask in its score tiles (one additive bfloat16 mask, as the
  official code adds them) and writes each token's output at its own
  position for `proj`: no pad, roll, partition, mask or reverse in
  memory. On the CPU its plain version materialises them, with the mask
  made once a block, grid shape and type (`WindowAttention.mask`) and
  kept until `derive` runs again.
The bfloat16 copies (`Linear`, `Conv2d` of models/sam.py: `weight_low`,
`bias_low`; the deformable branches' `weight_k`, `bias_k`) are made by
`BiRefNet.derive`: after seeding, after every `load_state_dict`, not at
each call; the parameters stay float32.

`FRAMES` counts the frames the network has run; pipeline/compiled.py
takes back what a capture counted and adds it at each replay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import deform_conv as KDC
from image_segmenter_tpu_torch.kernels import swin_attention as KSW
from image_segmenter_tpu_torch.models.sam import Conv2d, Linear, _lecun
from image_segmenter_tpu_torch.utils.profiling import replayed_counter, \
    setup_span

FRAMES = replayed_counter(__name__, "FRAMES")

# the decoder's fixed widths (decoder_blocks.py, aspp.py): a block's inner
# channels, an ASPP branch's, the gates' and SimpleConvs' inner channels
INTER = 64
BRANCH = 256
GATE = 16
DEFORM_KERNELS = (1, 3, 7)  # aspp_deforms; aspp1 is a fourth of kernel 1


@dataclass(frozen=True)
class BiRefNetConfig:
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 4

    @property
    def widths(self) -> tuple:
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))

    @property
    def channels(self) -> tuple:
        """`lateral_channels_in_collection` with `mul_scl_ipt = 'cat'`:
        each scale's width twice, from the coarsest."""
        return tuple(2 * c for c in reversed(self.widths))


SWIN_L = BiRefNetConfig()
CONFIGS = {"birefnet_swin_l": SWIN_L}


def bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """`F.interpolate(mode='bilinear', align_corners=True)`, the
    official code's resize everywhere; the identity at x's own size."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


# ---------------------------------------------------------------------------
# Swin-L
# ---------------------------------------------------------------------------

def relative_position_index(ws: int) -> torch.Tensor:
    """(ws^2, ws^2) int64: (yi - yj + ws - 1) (2 ws - 1) + xi - xj + ws - 1
    for positions i, j of a window."""
    ar = torch.arange(ws)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + ws - 1) * (2 * ws - 1) + rel[1] + ws - 1


def shift_mask(hp: int, wp: int, ws: int, shift: int,
               device=None) -> torch.Tensor:
    """(nW, ws^2, ws^2) float32: -100 between positions of a window that
    come from different regions of the rolled (hp, wp) grid, else 0
    (BasicLayer.forward)."""
    img = torch.zeros((hp, wp), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, wsl in enumerate(cuts):
            img[hs, wsl] = 3 * i + j
    win = img.view(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


class WindowAttention(nn.Module):
    """Attention within the 12 x 12 windows of a block's (shifted) grid,
    with the table's bias, then `proj`. On a card the window attention is
    kernels/swin_attention's kernel, which reads the table itself; on the
    CPU its plain version takes the mask that `mask` materialises."""

    def __init__(self, dim: int, ws: int, num_heads: int):
        super().__init__()
        self.ws, self.num_heads = ws, num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(ws))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        # the plain version's additive masks by (grid, shifted, type,
        # device): `mask`
        self.masks: dict = {}

    def bias(self) -> torch.Tensor:
        """The gathered table bias (heads, ws^2, ws^2), float32."""
        n = self.ws * self.ws
        return self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1) \
            .permute(2, 0, 1)

    def mask(self, hp: int, wp: int, shift: int, dtype,
             device) -> torch.Tensor:
        """The additive mask of a (hp, wp) grid in `dtype`: the table bias
        (1, heads, n, n), plus the shift mask in a shifted block (nW,
        heads, n, n), made at the first call of its key."""
        key = (hp, wp, shift, dtype, str(device)) if shift else \
            (dtype, str(device))
        m = self.masks.get(key)
        if m is None:
            with torch.no_grad():
                b = self.bias().to(device)
                if shift:
                    b = b[None] + shift_mask(hp, wp, self.ws, shift,
                                             device)[:, None]
                else:
                    b = b[None]
                m = self.masks[key] = b.to(dtype).contiguous()
        return m

    def forward(self, y: torch.Tensor, shift: int) -> torch.Tensor:
        """y (B, H, W, C), the normalised grid in the operands' type ->
        proj of its window attention, (B, H, W, C)."""
        h, w = y.shape[1:3]
        lin = self.qkv
        bias = lin.bias_low if y.dtype == torch.bfloat16 else lin.bias
        mask = None
        if y.device.type == "cpu":
            ws = self.ws
            mask = self.mask(-(-h // ws) * ws, -(-w // ws) * ws, shift,
                             y.dtype, y.device)
        o = KSW.attention(lin(y), bias, self.relative_position_bias_table,
                          shift, self.scale, mask=mask)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ws: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        """x (B, H, W, C) float32, the residual stream; `dt` the type of
        the attention's and the MLP's operands."""
        x = x + self.attn(self.norm1(x).to(dt), self.shift)
        return x + self.mlp(self.norm2(x).to(dt))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x).to(dt)).float()


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, ws: int,
                 mlp_ratio: float, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, ws, 0 if i % 2 == 0
                                 else ws // 2, mlp_ratio)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = Conv2d(3, dim, kernel_size=patch, stride=patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        """(B, 3, H, W) float32 -> (B, H/4, W/4, C) float32, the
        convolution channels-last so that its output is the token grid."""
        p = self.patch
        h, w = x.shape[2:]
        if h % p or w % p:
            x = F.pad(x, (0, -w % p, 0, -h % p))
        y = self.proj(x.to(dt, memory_format=torch.channels_last))
        return self.norm(y.permute(0, 2, 3, 1).float())


class SwinTransformer(nn.Module):
    def __init__(self, cfg: BiRefNetConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            BasicLayer(cfg.widths[i], cfg.depths[i], cfg.num_heads[i],
                       cfg.window_size, cfg.mlp_ratio, i < n - 1)
            for i in range(n))
        for i, c in enumerate(cfg.widths):
            self.add_module(f"norm{i}", nn.LayerNorm(c))

    def forward(self, x: torch.Tensor, dt) -> list:
        """(B, 3, H, W) float32 -> the four stages' normalised outputs
        (B, C_i, H_i, W_i) in `dt`, channels-last."""
        x = self.patch_embed(x, dt)
        outs = []
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, dt)
            outs.append(getattr(self, f"norm{i}")(x).to(dt)
                        .permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x, dt)
        return outs


# ---------------------------------------------------------------------------
# the decoder's blocks
# ---------------------------------------------------------------------------

def conv_bn(conv: Conv2d, bn, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """conv, its BatchNorm (eval; folded into the bfloat16 copies for a
    bfloat16 x), and a ReLU."""
    y = conv(x)
    if bn is not None and x.dtype != torch.bfloat16:
        y = bn(y)
    return F.relu(y) if relu else y


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    """(weight, bias) of conv then bn in eval, float32."""
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    w = conv.weight * scale.view(-1, 1, 1, 1)
    b = conv.bias if conv.bias is not None else torch.zeros_like(bn.bias)
    return w, (b - bn.running_mean) * scale + bn.bias


class DeformableConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.offset_conv = Conv2d(cin, 2 * k * k, k, padding=k // 2)
        self.modulator_conv = Conv2d(cin, k * k, k, padding=k // 2)
        self.regular_conv = Conv2d(cin, cout, k, padding=k // 2, bias=False)

    def offsets(self, x: torch.Tensor):
        """(offset (B, 2 k^2, H, W), modulator 2 sigmoid (B, k^2, H, W)),
        float32 from here on."""
        cl = torch.channels_last
        return (self.offset_conv(x).float().contiguous(memory_format=cl),
                (2.0 * torch.sigmoid(self.modulator_conv(x).float()))
                .contiguous(memory_format=cl))


class _ASPPModuleDeformable(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.atrous_conv = DeformableConv2d(cin, cout, k)
        self.bn = nn.BatchNorm2d(cout)
        # the folded weight (N, k, k, C) bfloat16 and bias (N,) float32
        self.register_buffer("weight_k", None, persistent=False)
        self.register_buffer("bias_k", None, persistent=False)

    def forward(self, x: torch.Tensor, out: torch.Tensor) -> None:
        """The branch's ReLU(BN(deform_conv(x))) into `out`: bfloat16
        with the BatchNorm folded, or float32 (the CPU only: the kernel
        raises on it)."""
        dc = self.atrous_conv
        off, m = dc.offsets(x)
        if x.dtype == torch.bfloat16:
            KDC.deform_conv(x, off, m, self.weight_k, self.bias_k, relu=True,
                            out=out)
            return
        y = KDC.deform_conv(x, off, m,
                            dc.regular_conv.weight.permute(0, 2, 3, 1))
        out.copy_(F.relu(self.bn(y)))


class ASPPDeformable(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.aspp1 = _ASPPModuleDeformable(cin, BRANCH, 1)
        self.aspp_deforms = nn.ModuleList(
            _ASPPModuleDeformable(cin, BRANCH, k) for k in DEFORM_KERNELS)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)), Conv2d(cin, BRANCH, 1, bias=False),
            nn.BatchNorm2d(BRANCH), nn.ReLU(inplace=True))
        self.conv1 = Conv2d(BRANCH * (2 + len(DEFORM_KERNELS)), cin, 1,
                            bias=False)
        self.bn1 = nn.BatchNorm2d(cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 64, H, W) channels-last: the five branches written into
        one (B, 1280, H, W) channels-last tensor, then conv1, bn1, ReLU."""
        b, _, h, w = x.shape
        x = x.contiguous(memory_format=torch.channels_last)
        cat = torch.empty((b, BRANCH * (2 + len(DEFORM_KERNELS)), h, w),
                          dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        for i, m in enumerate((self.aspp1, *self.aspp_deforms)):
            m(x, cat[:, i * BRANCH:(i + 1) * BRANCH])
        gp = self.global_avg_pool
        pooled = x.float().mean((2, 3), keepdim=True).to(x.dtype)
        cat[:, -BRANCH:] = conv_bn(gp[1], gp[2], pooled, True)
        return conv_bn(self.conv1, self.bn1, cat, True)


class BasicDecBlk(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_in = Conv2d(cin, INTER, 3, padding=1)
        self.bn_in = nn.BatchNorm2d(INTER)
        self.dec_att = ASPPDeformable(INTER)
        self.conv_out = Conv2d(INTER, cout, 3, padding=1)
        self.bn_out = nn.BatchNorm2d(cout)

    def forward(self, x):
        x = self.dec_att(conv_bn(self.conv_in, self.bn_in, x, True))
        return conv_bn(self.conv_out, self.bn_out, x, False)


class SimpleConvs(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2d(cin, INTER, 3, padding=1)
        self.conv_out = Conv2d(INTER, cout, 3, padding=1)

    def forward(self, x):
        return self.conv_out(self.conv1(x))


class BasicLatBlk(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


def _gdt(c: int) -> nn.Sequential:
    return nn.Sequential(Conv2d(c, GATE, 3, padding=1), nn.BatchNorm2d(GATE),
                         nn.ReLU(inplace=True))


def patches(x: torch.Tensor, g: int, dt) -> torch.Tensor:
    """`Decoder.get_patches_batch`: (B, 3, H, W) cut into g x g patches
    stacked on the channels, the patch of column j and row i at channels
    3 (j g + i) to 3 (j g + i) + 2; in `dt`, channels-last."""
    b, c, h, w = x.shape
    hh, ww = h // g, w // g
    y = x.to(dt).view(b, c, g, hh, g, ww).permute(0, 3, 5, 4, 2, 1)
    return y.reshape(b, hh, ww, g * g * c).permute(0, 3, 1, 2)


def _conv1x1_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) against a (C,) weight -> (B, 1, H, W): products and
    sums in float32."""
    return (x.permute(0, 2, 3, 1).float() @ w.float()).unsqueeze(1)


class Decoder(nn.Module):
    def __init__(self, ch: tuple):
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
        self.conv_out1 = nn.Sequential(Conv2d(ch[3] // 2 + ch[3] // 8, 1, 1))
        self.lateral_block4 = BasicLatBlk(ch[1], ch[1])
        self.lateral_block3 = BasicLatBlk(ch[2], ch[2])
        self.lateral_block2 = BasicLatBlk(ch[3], ch[3])
        # training heads, kept so that the published state dict loads
        self.conv_ms_spvn_4 = Conv2d(ch[1], 1, 1)
        self.conv_ms_spvn_3 = Conv2d(ch[2], 1, 1)
        self.conv_ms_spvn_2 = Conv2d(ch[3], 1, 1)
        for i, c in ((4, ch[1]), (3, ch[2]), (2, ch[3])):
            self.add_module(f"gdt_convs_{i}", _gdt(c))
            self.add_module(f"gdt_convs_pred_{i}",
                            nn.Sequential(Conv2d(GATE, 1, 1)))
            self.add_module(f"gdt_convs_attn_{i}",
                            nn.Sequential(Conv2d(GATE, 1, 1)))

    def gate(self, p: torch.Tensor, i: int) -> torch.Tensor:
        """p * sigmoid(gdt_convs_attn_i(gdt_convs_i(p))), the sigmoid and
        the product in float32, the result in p's type."""
        g = getattr(self, f"gdt_convs_{i}")
        a = getattr(self, f"gdt_convs_attn_{i}")[0]
        s = torch.sigmoid(a(conv_bn(g[0], g[1], p, True)).float())
        return (p * s).to(p.dtype)

    def forward(self, x, x1, x2, x3, x4, dt) -> torch.Tensor:
        """x (B, 3, H, W) float32, the network's input; x1..x4 the
        encoder's scales and x4 squeezed, in `dt` -> logits (B, 1, H, W)
        float32."""
        h, w = x.shape[2:]

        def ipt(blk, like):
            return blk(patches(x, h // like.shape[2], dt))

        p4 = self.decoder_block4(torch.cat([x4, ipt(self.ipt_blk5, x4)], 1))
        p4 = self.gate(p4, 4)
        p3 = bilinear(p4, x3.shape[2:]) + self.lateral_block4(x3)
        p3 = self.decoder_block3(torch.cat([p3, ipt(self.ipt_blk4, p3)], 1))
        p3 = self.gate(p3, 3)
        p2 = bilinear(p3, x2.shape[2:]) + self.lateral_block3(x2)
        p2 = self.decoder_block2(torch.cat([p2, ipt(self.ipt_blk3, p2)], 1))
        p2 = self.gate(p2, 2)
        p1 = bilinear(p2, x1.shape[2:]) + self.lateral_block2(x1)
        p1 = self.decoder_block1(torch.cat([p1, ipt(self.ipt_blk2, p1)], 1))
        # conv_out1 on cat(bilinear(p1, (H, W)), ipt_blk1(x)), its part on
        # p1 before the resize (the module docstring)
        conv = self.conv_out1[0]
        wv, c1 = conv.weight.view(-1), p1.shape[1]
        out = bilinear(_conv1x1_f32(p1, wv[:c1]), (h, w))
        return out + _conv1x1_f32(ipt(self.ipt_blk1, x), wv[c1:]) \
            + conv.bias.float()


# ---------------------------------------------------------------------------
# the model, its seeded weights
# ---------------------------------------------------------------------------

class BiRefNet(nn.Module):
    """`bb`, `squeeze_module`, `decoder` under the official names; `half`
    sets the operands (module docstring)."""

    def __init__(self, cfg: BiRefNetConfig = SWIN_L, half: bool = True):
        super().__init__()
        self.cfg = cfg
        self.half = half
        ch = cfg.channels
        self.bb = SwinTransformer(cfg)
        self.squeeze_module = nn.Sequential(
            BasicDecBlk(ch[0] + sum(ch[1:]), ch[0]))
        self.decoder = Decoder(ch)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module.derive())
        self.eval()  # inference only: BatchNorm takes its running stats

    def forward_enc(self, x: torch.Tensor, dt) -> list:
        """The backbone at x's size and at half of it, concatenated at
        each scale, and the three finer scales' context on the coarsest
        (`mul_scl_ipt = 'cat'`, `cxt_num` 3)."""
        h, w = x.shape[2:]
        xs = self.bb(x, dt)
        ys = self.bb(bilinear(x, (h // 2, w // 2)), dt)
        xs = [torch.cat([a, bilinear(b, a.shape[2:])], 1)
              for a, b in zip(xs, ys)]
        g = xs[3].shape[2:]
        xs[3] = torch.cat([bilinear(a, g) for a in xs[:3]] + [xs[3]], 1)
        return xs

    def forward(self, x: torch.Tensor) -> list:
        """x (B, 3, H, W) float32 normalised, H and W multiples of 32 ->
        [logits (B, 1, H, W) float32]."""
        global FRAMES
        if x.shape[2] % 32 or x.shape[3] % 32:
            raise ValueError(f"BiRefNet takes sides that are multiples of "
                             f"32, got {tuple(x.shape[2:])}")
        dt = torch.bfloat16 if self.half else torch.float32
        with setup_span("birefnet.backbone"):
            x1, x2, x3, x4 = self.forward_enc(x, dt)
        with setup_span("birefnet.decoder"):
            x4 = self.squeeze_module(x4)
            logits = self.decoder(x, x1, x2, x3, x4, dt)
        FRAMES += x.shape[0]
        return [logits]

    @torch.no_grad()
    def derive(self) -> None:
        """Make the buffers computed from the parameters: with `half` the
        bfloat16 copies, each BatchNorm folded into the convolution before
        it; and forget the attention masks."""
        low = torch.bfloat16 if self.half else None
        for m in self.modules():
            if isinstance(m, WindowAttention):
                m.masks.clear()
            if isinstance(m, (Linear, Conv2d)):
                m.weight_low = None if low is None else m.weight.to(low)
                m.bias_low = None if low is None or m.bias is None \
                    else m.bias.to(low)
        if low is None:
            return
        for m in self.modules():
            pairs = []
            if isinstance(m, BasicDecBlk):
                pairs = [(m.conv_in, m.bn_in), (m.conv_out, m.bn_out)]
            elif isinstance(m, ASPPDeformable):
                pairs = [(m.global_avg_pool[1], m.global_avg_pool[2]),
                         (m.conv1, m.bn1)]
            elif isinstance(m, nn.Sequential) and len(m) == 3 \
                    and isinstance(m[1], nn.BatchNorm2d):
                pairs = [(m[0], m[1])]  # a gate's conv and BatchNorm
            elif isinstance(m, _ASPPModuleDeformable):
                w, b = _fold(m.atrous_conv.regular_conv, m.bn)
                m.weight_k = w.permute(0, 2, 3, 1).contiguous().to(low)
                m.bias_k = b.float().contiguous()
            for conv, bn in pairs:
                w, b = _fold(conv, bn)
                conv.weight_low, conv.bias_low = w.to(low), b.to(low)


def build(arch: str, half: bool = True) -> BiRefNet:
    return BiRefNet(CONFIGS[arch], half)


@torch.no_grad()
def seeded_init(model: BiRefNet, gen: torch.Generator) -> None:
    """Every parameter and buffer of the state dict, in module order, from
    `gen`, a generator on the model's device: LeCun-normal kernels cut at
    +-2 for every linear and convolution (the offset and modulator
    convolutions too, which the official code starts at zero: seeded,
    the sampling moves), zero biases, LayerNorms 1 and 0, BatchNorms the
    identity (weight 1, bias 0, mean 0, variance 1); the relative-position
    tables N(0, 1) (the official init is a normal of 0.02 cut at 2
    standard deviations: seeded, the bias moves the scores as much as
    q.k does); the tables' index as the official code computes it."""
    done = set()
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            w = m.weight
            fan_in = w.shape[1] if isinstance(m, nn.Linear) else w[0].numel()
            w.copy_(_lecun(w.shape, fan_in, gen))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, WindowAttention):
            m.relative_position_bias_table.normal_(generator=gen)
            m.relative_position_index.copy_(relative_position_index(m.ws))
        else:
            continue
        done.update(id(t) for t in m.parameters(recurse=False))
        done.update(id(t) for t in m.buffers(recurse=False))
    missed = [k for k, t in model.state_dict(keep_vars=True).items()
              if id(t) not in done]
    if missed:
        raise RuntimeError(f"seeded_init left {missed[:4]} unset")
    model.derive()


def parameter_counts(model: BiRefNet) -> dict:
    """Parameters of the backbone, the squeeze block, the decoder's
    inference path, the training heads, and all."""
    heads = ("conv_ms_spvn_", "gdt_convs_pred_")
    count = {"backbone": 0, "squeeze": 0, "decoder": 0, "training_heads": 0}
    for name, p in model.named_parameters():
        part = name.split(".")[0]
        if part == "bb":
            count["backbone"] += p.numel()
        elif part == "squeeze_module":
            count["squeeze"] += p.numel()
        elif any(h in name for h in heads):
            count["training_heads"] += p.numel()
        else:
            count["decoder"] += p.numel()
    count["all"] = sum(count.values())
    return count

