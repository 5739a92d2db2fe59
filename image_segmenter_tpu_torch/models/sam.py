"""Segment Anything (Kirillov et al. 2023, ICCV) as PyTorch modules: the
ViT image encoder, the prompt encoder's box path and the two-way mask
decoder, with their pre- and post-processing.

The arithmetic is that of facebookresearch/segment-anything
(`segment_anything/modeling/image_encoder.py`, `prompt_encoder.py`,
`mask_decoder.py`, `transformer.py`, `common.py`, `utils/transforms.py`
and `predictor.py`), and the module names are its own, so that a state
dict of the published checkpoints (`sam_vit_h_4b8939.pth`, `sam_vit_b_
01ec64.pth`) loads strictly. `VIT_H` and `VIT_B` are `build_sam_vit_h`'s
and `build_sam_vit_b`'s widths.

Image encoder: a 16 x 16 patch embedding and an absolute position table,
then blocks of pre-norm attention and MLP. Windowed blocks zero-pad the
token grid up to a multiple of the window (64 -> 70 at 1024) and attend
within each window, the padded tokens as queries and keys like any
other; global blocks attend over the whole grid. Every attention adds
the query-dependent decomposed relative-position bias
(`add_decomposed_rel_pos`). The neck maps to 256 channels.

Precision (`half`, the Session's switch): with `half=False` everything
is float32 (the parameters' own type), the official code's arithmetic
op for op. With `half=True` the encoder's patch embedding, linears,
attention and neck convolutions take bfloat16 operands and accumulate in
float32: attention goes through kernels/sam_attention.attention, which
adds the decomposed bias, rounded to bfloat16 as an additive mask would
be, inside its score tiles and keeps the softmax statistics in float32
(on the CPU its plain version, the bias materialised). It reads q, k and
v in place from the qkv projection and hands `proj` its output as it
is: one launch a block. The residual stream and the LayerNorms stay
float32. The prompt encoder and the mask decoder are float32 in both.
The bfloat16 copies of the encoder's weights and of its gathered
relative-position tables are made once (`Sam.derive`: after seeding,
after every `load_state_dict` and by `Session`), not at each call; the
parameters themselves stay float32.

`FRAMES` and `PROMPTS` count the frames and box prompts the network
stage has run (`prompted_logits`); pipeline/compiled.py takes back what
a capture counted and adds it at each replay, as for the kernels'
launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import sam_attention as SA
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.utils.profiling import replayed_counter, \
    setup_span

FRAMES = replayed_counter(__name__, "FRAMES")
PROMPTS = replayed_counter(__name__, "PROMPTS")

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class SamConfig:
    embed_dim: int
    depth: int
    num_heads: int
    global_attn_indexes: Tuple[int, ...]
    window_size: int = 14
    patch_size: int = 16
    img_size: int = 1024
    mlp_ratio: float = 4.0
    prompt_dim: int = 256        # the neck's and the decoder's width
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp: int = 2048
    multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden: int = 256
    mask_in_chans: int = 16

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


VIT_H = SamConfig(1280, 32, 16, (7, 15, 23, 31))
VIT_B = SamConfig(768, 12, 12, (2, 5, 8, 11))
CONFIGS = {"sam_vit_h": VIT_H, "sam_vit_b": VIT_B}


class Linear(nn.Linear):
    """nn.Linear that runs a bfloat16 input on the bfloat16 copies of its
    weight and bias (`weight_low`, `bias_low`: buffers outside the state
    dict, made by `Sam.derive`)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias)
        self.register_buffer("weight_low", None, persistent=False)
        self.register_buffer("bias_low", None, persistent=False)

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return F.linear(x, self.weight_low, self.bias_low)
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with `Linear`'s bfloat16 copies."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("weight_low", None, persistent=False)
        self.register_buffer("bias_low", None, persistent=False)

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            return self._conv_forward(x, self.weight_low, self.bias_low)
        return self._conv_forward(x, self.weight, self.bias)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW tensor: mean and biased
    variance at each pixel (common.py)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, embedding_dim: int, mlp_dim: int, act=nn.GELU,
                 linear=nn.Linear):
        super().__init__()
        self.lin1 = linear(embedding_dim, mlp_dim)
        self.lin2 = linear(mlp_dim, embedding_dim)
        self.act = act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def rel_index(size: int, device) -> torch.Tensor:
    """`get_rel_pos`'s table index for equal query and key sizes: the
    relative distance i - j shifted to be non-negative."""
    i = torch.arange(size, device=device)
    return i[:, None] - i[None, :] + (size - 1)


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B * nW, ws, ws, C) windows, zero-padded to a
    multiple of ws; and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c), \
        (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, hp, wp, -1)
    if hp > h or wp > w:
        x = x[:, :h, :w, :].contiguous()
    return x


class Attention(nn.Module):
    """Multi-head attention over a (B, h, w, D) grid with the decomposed
    relative-position bias (image_encoder.py's Attention)."""

    def __init__(self, dim: int, num_heads: int, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.input_size = tuple(input_size)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))
        # the gathered tables (h, h, c) and (w, w, c), bfloat16: derive()
        self.register_buffer("rh_low", None, persistent=False)
        self.register_buffer("rw_low", None, persistent=False)

    def tables(self):
        """Rh (h, h, c) and Rw (w, w, c) gathered from the parameters."""
        h, w = self.input_size
        dev = self.rel_pos_h.device
        return (self.rel_pos_h[rel_index(h, dev)],
                self.rel_pos_w[rel_index(w, dev)])

    def forward(self, x):
        b, h, w, _ = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, -1).permute(2, 0, 3, 1, 4)
        low = x.dtype == torch.bfloat16
        if low:
            # (b, nh, h w, c) views of the projection, which the kernel
            # reads in place
            q, k, v = qkv.unbind(0)
        else:
            q, k, v = qkv.reshape(3, b * nh, h * w, -1).unbind(0)
        rh, rw = (self.rh_low, self.rw_low) if low else self.tables()
        r_q = q.reshape(b * nh, h, w, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        if low:
            # the bias formed inside the kernel's score tiles; the output
            # comes as (b, h w, nh c)
            x = SA.attention(q, k, v, rel_h, rel_w, self.scale)
            return self.proj(x.view(b, h, w, -1))
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = (attn.view(b * nh, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(b * nh, h * w, h * w)
        x = attn.softmax(dim=-1) @ v
        x = x.view(b, nh, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w,
                                                                   -1)
        return self.proj(x)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, input_size):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, input_size if window_size == 0
                              else (window_size, window_size))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), linear=Linear)
        self.window_size = window_size

    def forward(self, x, dt):
        """x (B, H, W, D) float32; `dt` the type of the attention's and the
        MLP's operands."""
        shortcut = x
        x = self.norm1(x).to(dt)
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x).to(dt))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, kernel_size=patch,
                           stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        g = cfg.grid
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, cfg.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio,
                  0 if i in cfg.global_attn_indexes else cfg.window_size,
                  (g, g))
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            Conv2d(cfg.embed_dim, cfg.prompt_dim, kernel_size=1, bias=False),
            LayerNorm2d(cfg.prompt_dim),
            Conv2d(cfg.prompt_dim, cfg.prompt_dim, kernel_size=3, padding=1,
                   bias=False),
            LayerNorm2d(cfg.prompt_dim))

    def forward(self, x, dt=torch.float32):
        """(B, 3, S, S) float32 -> (B, prompt_dim, S/16, S/16) float32.
        The patch embedding runs channels-last, so that its (B, g, g, D)
        output, and the residual stream after it, are contiguous."""
        x = self.patch_embed(x.to(dt, memory_format=torch.channels_last)) \
            + self.pos_embed
        for blk in self.blocks:
            x = blk(x, dt)
        n = self.neck
        x = n[1](n[0](x.permute(0, 3, 1, 2).to(dt)).float())
        return n[3](n[2](x.to(dt)).float())


# ---------------------------------------------------------------------------
# prompt encoder (the box path; the point and mask paths' parameters are
# kept so that the published state dicts load)
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    """Positional encoding with random spatial frequencies."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros((2, num_pos_feats)))

    def _pe_encoding(self, coords):
        coords = 2 * coords - 1
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2 * np.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def forward(self, size):
        """The (C, h, w) encoding of the cell centres of an h x w grid."""
        h, w = size
        g = self.positional_encoding_gaussian_matrix
        grid = torch.ones((h, w), device=g.device, dtype=g.dtype)
        y_embed = (grid.cumsum(dim=0) - 0.5) / h
        x_embed = (grid.cumsum(dim=1) - 0.5) / w
        pe = self._pe_encoding(torch.stack([x_embed, y_embed], dim=-1))
        return pe.permute(2, 0, 1)

    def forward_with_coords(self, coords_input, image_size):
        """(B, N, 2) pixel coordinates of an image_size input -> (B, N, C)."""
        coords = coords_input.clone()
        coords[:, :, 0] = coords[:, :, 0] / image_size[1]
        coords[:, :, 1] = coords[:, :, 1] / image_size[0]
        return self._pe_encoding(coords.to(torch.float))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d, g = cfg.prompt_dim, cfg.grid
        self.embed_dim = d
        self.input_image_size = (cfg.img_size, cfg.img_size)
        self.image_embedding_size = (g, g)
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        mc = cfg.mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, kernel_size=2, stride=2),
            LayerNorm2d(mc // 4), nn.GELU(),
            nn.Conv2d(mc // 4, mc, kernel_size=2, stride=2),
            LayerNorm2d(mc), nn.GELU(),
            nn.Conv2d(mc, d, kernel_size=1))
        self.no_mask_embed = nn.Embedding(1, d)

    def get_dense_pe(self):
        return self.pe_layer(self.image_embedding_size)[None]

    def forward(self, boxes):
        """(B, 4) boxes in the resized frame's pixels -> sparse (B, 2, d),
        dense (B, d, g, g)."""
        coords = (boxes + 0.5).reshape(-1, 2, 2)
        corner = self.pe_layer.forward_with_coords(coords,
                                                   self.input_image_size)
        corner[:, 0, :] += self.point_embeddings[2].weight
        corner[:, 1, :] += self.point_embeddings[3].weight
        g = self.image_embedding_size
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            boxes.shape[0], -1, g[0], g[1])
        return corner, dense


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------

class TokenAttention(nn.Module):
    """transformer.py's Attention: projections to embedding_dim /
    downsample_rate, heads, a plain softmax(q k^T / sqrt(c))."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        self.num_heads = num_heads
        internal = embedding_dim // downsample_rate
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def _heads(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads) \
            .transpose(1, 2)

    def forward(self, q, k, v):
        q = self._heads(self.q_proj(q))
        k = self._heads(self.k_proj(k))
        v = self._heads(self.v_proj(v))
        attn = q @ k.permute(0, 1, 3, 2)
        attn = attn / math.sqrt(q.shape[-1])
        out = torch.softmax(attn, dim=-1) @ v
        b, nh, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, nh * c))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.self_attn = TokenAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = TokenAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = TokenAttention(dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries
                             + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, num_heads, mlp_dim, i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = TokenAttention(dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        keys = image_embedding.flatten(2).permute(0, 2, 1)
        image_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    """mask_decoder.py's MLP: ReLU between `num_layers` linears."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k) for n, k in
                                    zip([input_dim] + h, h + [output_dim]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.prompt_dim
        self.transformer = TwoWayTransformer(cfg.decoder_depth, d,
                                             cfg.decoder_heads,
                                             cfg.decoder_mlp)
        self.num_mask_tokens = cfg.multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, kernel_size=2, stride=2),
            LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, kernel_size=2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(d, cfg.iou_head_hidden,
                                       self.num_mask_tokens,
                                       cfg.iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse, dense):
        """One prompt a frame, `multimask_output=False`: the low-resolution
        logits (B, 1, 4g, 4g) of mask 0 and its IoU prediction (B, 1)."""
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([tokens[None].expand(sparse.shape[0], -1, -1),
                            sparse], dim=1)
        src = image_embeddings + dense
        b, c, h, w = src.shape
        hs, src = self.transformer(src, image_pe.expand(b, -1, -1, -1),
                                   tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]
        up = self.output_upscaling(src.transpose(1, 2).view(b, c, h, w))
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i, :]) for i, mlp
                                in enumerate(self.output_hypernetworks_mlps)],
                               dim=1)
        b, c, h, w = up.shape
        masks = (hyper_in @ up.view(b, c, h * w)).view(b, -1, h, w)
        iou_pred = self.iou_prediction_head(iou_token_out)
        return masks[:, 0:1], iou_pred[:, 0:1]


# ---------------------------------------------------------------------------
# the model, its seeded weights, pre- and post-processing
# ---------------------------------------------------------------------------

class Sam(nn.Module):
    """The three parts under the official names; `half` sets the encoder's
    operands (module docstring)."""

    def __init__(self, cfg: SamConfig, half: bool = True):
        super().__init__()
        self.cfg = cfg
        self.half = half
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module.derive())

    @torch.no_grad()
    def derive(self) -> None:
        """Make the buffers computed from the parameters: with `half` the
        encoder's bfloat16 weights and relative-position tables."""
        low = torch.bfloat16 if self.half else None
        for m in self.image_encoder.modules():
            if isinstance(m, (Linear, Conv2d)):
                m.weight_low = None if low is None else m.weight.to(low)
                m.bias_low = None if low is None or m.bias is None \
                    else m.bias.to(low)
            elif isinstance(m, Attention):
                rh, rw = m.tables()
                m.rh_low = None if low is None else rh.to(low)
                m.rw_low = None if low is None else rw.to(low)

    def forward(self, x, boxes):
        """x (B, 3, S, S) normalised and padded, boxes (B, 4) in the
        resized frame's pixels -> (logits (B, 1, 4g, 4g), iou (B, 1))."""
        dt = torch.bfloat16 if self.half else torch.float32
        with setup_span("sam.encoder"):
            emb = self.image_encoder(x, dt)
        with setup_span("sam.prompt"):
            sparse, dense = self.prompt_encoder(boxes)
            pe = self.prompt_encoder.get_dense_pe()
        with setup_span("sam.decoder"):
            return self.mask_decoder(emb, pe, sparse, dense)


def build(arch: str, half: bool = True) -> Sam:
    return Sam(CONFIGS[arch], half)


# Flax's variance_scaling truncated normal: a standard normal cut at +-2,
# rescaled by this constant so the cut distribution keeps unit variance
_TRUNC_STD = 0.87962566103423978
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))


def _lecun(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """LeCun normal cut at +-2 std, by the inverse CDF of float32 uniforms
    drawn on the generator's device."""
    u = _LO + (1.0 - 2.0 * _LO) * torch.rand(shape, generator=gen,
                                             device=gen.device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


@torch.no_grad()
def seeded_init(model: Sam, gen: torch.Generator) -> None:
    """Every parameter and buffer of the state dict, in module order, from
    `gen`, a generator on the model's device: LeCun-normal kernels cut at
    +-2 for the linears and (transposed) convolutions, zero biases,
    LayerNorms 1 and 0; `pos_embed`, `rel_pos_h` and `rel_pos_w` N(0,
    0.02^2) (the official init is zeros: seeded, the relative bias does
    something); the embeddings and the Gaussian frequencies N(0, 1)."""
    done = set()
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w.shape[1] if isinstance(m, nn.Linear) else (
                w.shape[0] * w[0, 0].numel()
                if isinstance(m, nn.ConvTranspose2d) else w[0].numel())
            w.copy_(_lecun(w.shape, fan_in, gen))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=gen)
        elif isinstance(m, ImageEncoderViT):
            m.pos_embed.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, Attention):
            m.rel_pos_h.normal_(0.0, 0.02, generator=gen)
            m.rel_pos_w.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, PositionEmbeddingRandom):
            m.positional_encoding_gaussian_matrix.normal_(generator=gen)
        else:
            continue
        done.update(id(t) for t in m.parameters(recurse=False))
        done.update(id(t) for t in m.buffers(recurse=False))
    missed = [k for k, t in model.state_dict(keep_vars=True).items()
              if id(t) not in done]
    if missed:
        raise RuntimeError(f"seeded_init left {missed[:4]} unset")
    model.derive()


def preprocess_shape(h: int, w: int, long_side: int) -> tuple:
    """ResizeLongestSide.get_preprocess_shape: (newh, neww)."""
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def preprocess(imgs: torch.Tensor, img_size: int, mean: torch.Tensor,
               std: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (B, 3, S, S) float32: the longest side to S by
    PIL's bilinear filter (u8), (x - mean) / std, zeros to the bottom and
    right."""
    h, w = imgs.shape[1:3]
    nh, nw = preprocess_shape(h, w, img_size)
    small = RZ.resize_u8(imgs, (nh, nw), RZ.BILINEAR_PIL)
    x = (small.permute(0, 3, 1, 2) - mean[:, None, None]) / std[:, None, None]
    return F.pad(x, (0, img_size - nw, 0, img_size - nh))


def transform_boxes(boxes: torch.Tensor, hw, img_size: int) -> torch.Tensor:
    """(B, 4) x0, y0, x1, y1 in the frame's pixels -> the resized frame's,
    scaled in float64 (ResizeLongestSide.apply_boxes) and then float32."""
    h, w = hw
    nh, nw = preprocess_shape(h, w, img_size)
    c = boxes.to(torch.float64).reshape(-1, 2, 2)
    c = torch.stack([c[..., 0] * (nw / w), c[..., 1] * (nh / h)], -1)
    return c.reshape(-1, 4).to(torch.float32)


def postprocess(low: torch.Tensor, hw, img_size: int) -> torch.Tensor:
    """Sam.postprocess_masks: (B, 1, 4g, 4g) logits -> (B, 1, H, W)."""
    h, w = hw
    nh, nw = preprocess_shape(h, w, img_size)
    x = F.interpolate(low, (img_size, img_size), mode="bilinear",
                      align_corners=False)
    return F.interpolate(x[..., :nh, :nw], (h, w), mode="bilinear",
                         align_corners=False)


@torch.no_grad()
def prompted_logits(model: Sam, imgs: torch.Tensor, boxes: torch.Tensor,
                    mean: torch.Tensor, std: torch.Tensor):
    """The network stage on a (B, H, W, 3) u8 batch with one (x0, y0, x1,
    y1) box a frame: (alpha0 (B, H, W) u8, 255 where the full-size logit
    is above 0; low-resolution logits (B, 1, 4g, 4g); IoU (B, 1))."""
    global FRAMES, PROMPTS
    s = model.cfg.img_size
    hw = imgs.shape[1:3]
    low, iou = model(preprocess(imgs, s, mean, std),
                     transform_boxes(boxes, hw, s))
    full = postprocess(low, hw, s)[:, 0]
    alpha0 = (full > 0.0).to(torch.uint8) * 255
    FRAMES += imgs.shape[0]
    PROMPTS += boxes.shape[0]
    return alpha0, low, iou
