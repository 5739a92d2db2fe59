"""Segment Anything's forward with one box prompt, in plain PyTorch: the
reference the port's SAM is held to.

Written from the arithmetic of facebookresearch/segment-anything
(`modeling/image_encoder.py`, `prompt_encoder.py`, `mask_decoder.py`,
`transformer.py`, `common.py`, `utils/transforms.py`, `predictor.py`)
with its module names, so that one state dict loads into this and into
the port; it imports nothing of the port or of JAX. Eval only, float32,
one frame at a time, every attention materialised (softmax of the
scores plus the decomposed relative-position bias, then times V).

Departures from the official code: none intended in the arithmetic. The
weights are whatever the caller loads (the benchmark seeds them:
yardstick/sam_weights.py). Only the box path of the prompt encoder is
written; its point and mask paths' parameters are kept for loading.
`multimask_output=False`: mask 0 and its IoU, SamPredictor's advice for
one box.

`prec` sets the arithmetic of the image encoder's linears (qkv, proj,
lin1, lin2):
- "f32": float32 operands (the reference; TF32 stays off);
- "fp8": the control, below the configuration's bfloat16: each linear's
  input and weight rounded to float8 e4m3 with one scale a tensor (its
  largest magnitude maps to 448), as `nets.py`'s control rounds
  convolutions, then multiplied in float32;
- "bf16": the configuration's operands, each rounded to bfloat16 and
  multiplied in float32: a witness, not the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import plain

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
_FP8_MAX = 448.0

# build_sam_vit_h / build_sam_vit_b
WIDTHS = {
    "sam_vit_h": dict(embed_dim=1280, depth=32, num_heads=16,
                      global_attn_indexes=(7, 15, 23, 31)),
    "sam_vit_b": dict(embed_dim=768, depth=12, num_heads=12,
                      global_attn_indexes=(2, 5, 8, 11)),
}
COMMON = dict(window_size=14, patch_size=16, img_size=1024, mlp_ratio=4.0,
              prompt_dim=256, decoder_depth=2, decoder_heads=8,
              decoder_mlp=2048, multimask_outputs=3, iou_head_depth=3,
              iou_head_hidden=256, mask_in_chans=16)


def widths(arch: str, **over) -> dict:
    return {**COMMON, **WIDTHS.get(arch, {}), **over}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(x.abs().amax(), 1e-12) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class Lin(nn.Linear):
    """An encoder linear at the model's `prec`."""
    prec = "f32"

    def forward(self, x):
        if self.prec == "fp8":
            return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)
        if self.prec == "bf16":
            return F.linear(bf16_round(x), bf16_round(self.weight),
                            None if self.bias is None
                            else bf16_round(self.bias))
        return F.linear(x, self.weight, self.bias)


class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, d: int, m: int, act, lin=nn.Linear):
        super().__init__()
        self.lin1, self.lin2, self.act = lin(d, m), lin(m, d), act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


# ---------------------------------------------------------------- encoder

class EncAttention(nn.Module):
    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads, self.hd = heads, dim // heads
        self.qkv, self.proj = Lin(dim, 3 * dim), Lin(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, self.hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, self.hd))

    def forward(self, x):
        """x (1, h, w, D) or windows (n, h, w, D). The tables are indexed
        by the distance i - j from their centre, which for a grid of the
        table's own size is `get_rel_pos`'s i - j + h - 1."""
        b, h, w, d = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, self.hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(
            3, b * self.heads, h * w, self.hd).unbind(0)
        ih = torch.arange(h, device=x.device)
        iw = torch.arange(w, device=x.device)
        ch = (self.rel_pos_h.shape[0] - 1) // 2
        cw = (self.rel_pos_w.shape[0] - 1) // 2
        rh = self.rel_pos_h[ih[:, None] - ih[None, :] + ch]   # (h, h, c)
        rw = self.rel_pos_w[iw[:, None] - iw[None, :] + cw]   # (w, w, c)
        r_q = q.reshape(-1, h, w, self.hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
        attn = (q * self.hd ** -0.5) @ k.transpose(-2, -1)
        attn = attn.view(-1, h, w, h, w) + rel_h[..., :, None] \
            + rel_w[..., None, :]
        attn = attn.view(-1, h * w, h * w).softmax(dim=-1)
        out = (attn @ v).view(b, self.heads, h, w, self.hd)
        return self.proj(out.permute(0, 2, 3, 1, 4).reshape(b, h, w, d))


class EncBlock(nn.Module):
    def __init__(self, dim, heads, ratio, window, grid, pad_windows=True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EncAttention(dim, heads, window or grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * ratio), nn.GELU, Lin)
        self.window = window
        self.pad_windows = pad_windows

    def forward(self, x):
        s = x
        x = self.norm1(x)
        if self.window:
            x = self._windowed(x)
        else:
            x = self.attn(x)
        x = s + x
        return x + self.mlp(self.norm2(x))

    def _windowed(self, x):
        """Zero-pad to a multiple of the window, attend in each window (all
        windows as one batch), crop. `pad_windows=False` is a fault for
        the tests: each window attends over its tokens inside the frame
        only, the padded ones masked out of its keys."""
        _, h, w, d = x.shape
        ws = self.window
        if not self.pad_windows:
            out = torch.zeros_like(x)
            for i in range(0, h, ws):
                for j in range(0, w, ws):
                    out[:, i:i + ws, j:j + ws] = self.attn(
                        x[:, i:i + ws, j:j + ws])
            return out
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        xp = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
        win = xp.view(1, hp // ws, ws, wp // ws, ws, d) \
            .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, d)
        out = self.attn(win).view(1, hp // ws, wp // ws, ws, ws, d) \
            .permute(0, 1, 3, 2, 4, 5).reshape(1, hp, wp, d)
        return out[:, :h, :w]


class ImageEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, g = cfg["embed_dim"], cfg["img_size"] // cfg["patch_size"]
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, cfg["patch_size"],
                                          cfg["patch_size"])
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, d))
        self.blocks = nn.ModuleList(
            EncBlock(d, cfg["num_heads"], cfg["mlp_ratio"],
                     0 if i in cfg["global_attn_indexes"]
                     else cfg["window_size"], g)
            for i in range(cfg["depth"]))
        p = cfg["prompt_dim"]
        self.neck = nn.Sequential(nn.Conv2d(d, p, 1, bias=False),
                                  LayerNorm2d(p),
                                  nn.Conv2d(p, p, 3, padding=1, bias=False),
                                  LayerNorm2d(p))

    def forward(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------- prompts

class PE(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, n))

    def encode(self, coords):
        coords = 2 * coords - 1
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2 * np.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        p, mc = cfg["prompt_dim"], cfg["mask_in_chans"]
        self.size = cfg["img_size"]
        self.grid = cfg["img_size"] // cfg["patch_size"]
        self.pe_layer = PE(p // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, p)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, p)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, 2), LayerNorm2d(mc // 4), nn.GELU(),
            nn.Conv2d(mc // 4, mc, 2, 2), LayerNorm2d(mc), nn.GELU(),
            nn.Conv2d(mc, p, 1))
        self.no_mask_embed = nn.Embedding(1, p)

    def boxes(self, box):
        """(1, 4) box in the resized frame's pixels -> (1, 2, p)."""
        c = (box + 0.5).reshape(-1, 2, 2).clone()
        c[:, :, 0] = c[:, :, 0] / self.size
        c[:, :, 1] = c[:, :, 1] / self.size
        e = self.pe_layer.encode(c)
        e[:, 0, :] += self.point_embeddings[2].weight
        e[:, 1, :] += self.point_embeddings[3].weight
        return e

    def dense_pe(self):
        g = self.grid
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ones = torch.ones((g, g), device=dev)
        y = (ones.cumsum(0) - 0.5) / g
        x = (ones.cumsum(1) - 0.5) / g
        return self.pe_layer.encode(torch.stack([x, y], -1)).permute(2, 0, 1)


# ---------------------------------------------------------------- decoder

class TAttn(nn.Module):
    def __init__(self, d: int, heads: int, rate: int = 1):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d // rate), \
            nn.Linear(d, d // rate)
        self.v_proj, self.out_proj = nn.Linear(d, d // rate), \
            nn.Linear(d // rate, d)

    def forward(self, q, k, v):
        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)
        q, k, v = split(self.q_proj(q)), split(self.k_proj(k)), \
            split(self.v_proj(v))
        a = torch.softmax(q @ k.permute(0, 1, 3, 2)
                          / math.sqrt(q.shape[-1]), dim=-1)
        o = (a @ v).transpose(1, 2)
        return self.out_proj(o.reshape(o.shape[0], o.shape[1], -1))


class TwoWayBlock(nn.Module):
    def __init__(self, d, heads, mlp, first):
        super().__init__()
        self.self_attn = TAttn(d, heads)
        self.cross_attn_token_to_image = TAttn(d, heads, 2)
        self.cross_attn_image_to_token = TAttn(d, heads, 2)
        self.mlp = MLPBlock(d, mlp, nn.ReLU)
        for i in range(1, 5):
            setattr(self, f"norm{i}", nn.LayerNorm(d))
        self.first = first

    def forward(self, qs, ks, qpe, kpe):
        if self.first:
            qs = self.self_attn(qs, qs, qs)
        else:
            qs = qs + self.self_attn(qs + qpe, qs + qpe, qs)
        qs = self.norm1(qs)
        qs = self.norm2(qs + self.cross_attn_token_to_image(qs + qpe,
                                                            ks + kpe, ks))
        qs = self.norm3(qs + self.mlp(qs))
        ks = self.norm4(ks + self.cross_attn_image_to_token(ks + kpe,
                                                            qs + qpe, qs))
        return qs, ks


class Transformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["prompt_dim"]
        self.layers = nn.ModuleList(
            TwoWayBlock(d, cfg["decoder_heads"], cfg["decoder_mlp"], i == 0)
            for i in range(cfg["decoder_depth"]))
        self.final_attn_token_to_image = TAttn(d, cfg["decoder_heads"], 2)
        self.norm_final_attn = nn.LayerNorm(d)


class HeadMLP(nn.Module):
    def __init__(self, i, h, o, n):
        super().__init__()
        dims = [i] + [h] * (n - 1) + [o]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for j, layer in enumerate(self.layers):
            x = layer(x)
            x = F.relu(x) if j < len(self.layers) - 1 else x
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, n = cfg["prompt_dim"], cfg["multimask_outputs"] + 1
        self.transformer = Transformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(n, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4),
            nn.GELU(), nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            HeadMLP(d, d, d // 8, 3) for _ in range(n))
        self.iou_prediction_head = HeadMLP(d, cfg["iou_head_hidden"], n,
                                           cfg["iou_head_depth"])


class SamPlain(nn.Module):
    def __init__(self, arch: str = "sam_vit_h", prec: str = "f32", **over):
        super().__init__()
        self.cfg = widths(arch, **over)
        self.image_encoder = ImageEncoder(self.cfg)
        self.prompt_encoder = PromptEncoder(self.cfg)
        self.mask_decoder = MaskDecoder(self.cfg)
        for m in self.modules():
            if isinstance(m, Lin):
                m.prec = prec

    def decode(self, emb, box):
        """One frame: emb (1, p, g, g), box (1, 4) -> all mask logits
        (1, n, 4g, 4g) and IoU predictions (1, n)."""
        md, pe = self.mask_decoder, self.prompt_encoder
        sparse = pe.boxes(box)
        dense = pe.no_mask_embed.weight.reshape(1, -1, 1, 1)
        tokens = torch.cat([md.iou_token.weight, md.mask_tokens.weight])[None]
        tokens = torch.cat([tokens, sparse], dim=1)
        src = emb + dense
        _, c, h, w = src.shape
        keys = src.flatten(2).permute(0, 2, 1)
        kpe = pe.dense_pe()[None].flatten(2).permute(0, 2, 1)
        qs = tokens
        t = md.transformer
        for layer in t.layers:
            qs, keys = layer(qs, keys, tokens, kpe)
        qs = t.norm_final_attn(qs + t.final_attn_token_to_image(
            qs + tokens, keys + kpe, keys))
        up = md.output_upscaling(keys.transpose(1, 2).reshape(1, c, h, w))
        n = md.mask_tokens.weight.shape[0]
        hyper = torch.stack([mlp(qs[:, 1 + i]) for i, mlp in
                             enumerate(md.output_hypernetworks_mlps)], 1)
        masks = (hyper @ up.flatten(2)).view(1, n, *up.shape[2:])
        return masks, md.iou_prediction_head(qs[:, 0])


# -------------------------------------------------- pre- and post-processing

def preprocess_shape(h: int, w: int, long_side: int) -> tuple:
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def resize_bilinear_pil(img: torch.Tensor, dst_hw) -> torch.Tensor:
    """(1, H, W, 3) u8 -> PIL's antialiased bilinear filter, rounded half
    up to u8 (float64 contractions of float32 weights, as plain.resize_u8)."""
    b, h, w, c = img.shape
    dh, dw = dst_hw
    wy = torch.from_numpy(plain._pil_filter_row(dh, h, 1.0, _triangle)) \
        .to(img.device, torch.float64)
    wx = torch.from_numpy(plain._pil_filter_row(dw, w, 1.0, _triangle)) \
        .to(img.device, torch.float64)
    x = torch.matmul(wy, img.to(torch.float64).reshape(b, h, -1))
    x = x.reshape(b * dh, w, c).transpose(1, 2).reshape(-1, w)
    x = torch.matmul(x, wx.t()).to(torch.float32)
    x = x.reshape(b * dh, c, dw).transpose(1, 2).reshape(b, dh, dw, c)
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def transform_box(box: np.ndarray, hw, long_side: int) -> np.ndarray:
    """ResizeLongestSide.apply_boxes: float64 numpy, scaled per axis."""
    h, w = hw
    nh, nw = preprocess_shape(h, w, long_side)
    c = np.asarray(box, dtype=np.float64).reshape(-1, 2, 2).copy()
    c[..., 0] = c[..., 0] * (nw / w)
    c[..., 1] = c[..., 1] * (nh / h)
    return c.reshape(-1, 4)


def postprocess(low: torch.Tensor, hw, long_side: int) -> torch.Tensor:
    h, w = hw
    nh, nw = preprocess_shape(h, w, long_side)
    x = F.interpolate(low, (long_side, long_side), mode="bilinear",
                      align_corners=False)[..., :nh, :nw]
    return F.interpolate(x, (h, w), mode="bilinear", align_corners=False)


@torch.no_grad()
def predict(model: SamPlain, img_u8: torch.Tensor, box: np.ndarray,
            scale_boxes: bool = True, mask_index: int = 0):
    """One (H, W, 3) u8 frame and its (4,) box -> (full-size logits
    (H, W), low-resolution logits (1, 1, 4g, 4g), IoU (1, 1)), on the
    model's device. `scale_boxes=False` and `mask_index` other than 0
    are faults for the tests."""
    s = model.cfg["img_size"]
    dev = model.prompt_encoder.no_mask_embed.weight.device
    h, w = img_u8.shape[:2]
    nh, nw = preprocess_shape(h, w, s)
    small = resize_bilinear_pil(img_u8[None].to(dev), (nh, nw))
    mean = torch.tensor(PIXEL_MEAN, device=dev)[:, None, None]
    std = torch.tensor(PIXEL_STD, device=dev)[:, None, None]
    x = (small.permute(0, 3, 1, 2) - mean) / std
    x = F.pad(x, (0, s - nw, 0, s - nh))
    b = transform_box(box, (h, w), s) if scale_boxes \
        else np.asarray(box, dtype=np.float64)[None]
    bt = torch.as_tensor(b, dtype=torch.float, device=dev)
    emb = model.image_encoder(x)
    masks, iou = model.decode(emb, bt)
    low = masks[:, mask_index:mask_index + 1]
    return postprocess(low, (h, w), s)[0, 0], low, \
        iou[:, mask_index:mask_index + 1]
