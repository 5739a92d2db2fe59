"""BiRefNet's Swin-L window attention as one kernel that reads the token
grid in place.

Replaces no TPU kernel: the JAX package has no BiRefNet. It takes the
pad, the roll, the window partition, the materialised mask, the library
attention (`F.scaled_dot_product_attention`), the partition's reverse
and the roll back out of models/birefnet.WindowAttention's bfloat16
path. csrc/swin_attention.cu says what bounds it and how it is tiled.

`attention(qkv, bias, table, shift, scale, mask=None)`:
- qkv (B, H, W, 3C): the qkv projection of a block's unpadded, unrolled
  grid (a Linear acts token by token, so it commutes with the pad, the
  roll and the partition), q, k and v side by side, the heads side by
  side within each;
- bias (3C,): the projection's bias in qkv's type, which is what a pad
  token's q, k and v are (a zero row through the Linear);
- table (529, heads) float32: the relative-position bias table of 12 x 12
  windows, read as it is (no copy to remake after a load);
- shift: 0, or the roll of a shifted block;
- returns o (B, H, W, C) in qkv's type: each token's output at its own
  position, ready for the output projection.

The grid is padded with pad tokens to multiples of 12, rolled by -shift
and cut into 12 x 12 windows. Query i and key j of a window score
q.k * scale + bf16(table[(yi - yj + 11) 23 + xi - xj + 11] + m), where m
is -100 in a shifted block if the two come from different regions of the
roll (`models/birefnet.shift_mask`), else 0; pad keys stay in the
softmax (Swin's detection variant), which is float32; the unnormalised
probabilities are rounded to qkv's type for the product with v, the
output divided by the row's sum. A pad query's output is not kept.

A CPU tensor takes `attention_plain`, the same with the windows and the
mask materialised: `mask`, (windows or 1, heads, n, n) in qkv's type,
the caller's (`WindowAttention.mask`), and F.scaled_dot_product_attention,
whose arithmetic that is. A CUDA tensor launches the kernel, which takes
bfloat16 on one card, heads of `HEAD_DIM`, 12 x 12 windows, an even
shift below 12 and qkv whose last stride is 1, whose other strides are
multiples of 8 elements and whose data and bias are 16-byte aligned:
anything else raises. There is no fallback.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process; a Swin block is one
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

# the kernel's one instantiation: Swin-L's window and head dim
WINDOW = 12
HEAD_DIM = 32
TABLE_ROWS = (2 * WINDOW - 1) ** 2


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hp, Wp, C) -> (B nW, ws^2, C), windows in row-major order."""
    b, h, w, c = x.shape
    return x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, b: int, h: int,
                   w: int) -> torch.Tensor:
    """(B nW, ws^2, C) -> (B, h, w, C)."""
    return x.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, h, w, -1)


def attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                    mask: torch.Tensor, shift: int,
                    scale: float) -> torch.Tensor:
    """The kernel's function with the windows and the mask materialised:
    pad rows from the bias, roll, partition, the library attention with
    `mask` (a frame at a time where it differs by window), reverse, roll
    back, crop; (B, H, W, C) in qkv's type."""
    b, h, w, c3 = qkv.shape
    nh, n = mask.shape[1], mask.shape[-1]
    ws = math.isqrt(n)
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    x = qkv
    if hp > h or wp > w:
        x = bias.expand(b, hp, wp, c3).clone()
        x[:, :h, :w] = qkv
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    win = window_partition(x, ws)
    bw = win.shape[0]
    q, k, v = win.reshape(bw, n, 3, nh, c3 // (3 * nh)) \
        .permute(2, 0, 3, 1, 4).unbind(0)
    nw = mask.shape[0]
    if nw == 1:
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           scale=scale)
    else:  # the shift mask differs by window: a frame at a time
        o = torch.cat([F.scaled_dot_product_attention(
            q[i * nw:(i + 1) * nw], k[i * nw:(i + 1) * nw],
            v[i * nw:(i + 1) * nw], attn_mask=mask, scale=scale)
            for i in range(b)])
    o = window_reverse(o.transpose(1, 2).reshape(bw, n, c3 // 3), ws, b, hp,
                       wp)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return o[:, :h, :w]


def _check(qkv, bias, table, shift: int) -> tuple:
    """(B, H, W, C, heads) of operands the kernel takes; raises on any
    other."""
    if (qkv.dim() != 4 or table.dim() != 2 or table.shape[0] != TABLE_ROWS
            or tuple(bias.shape) != (qkv.shape[-1],)):
        raise ValueError(
            f"qkv is (B, H, W, 3C), bias (3C,), table ({TABLE_ROWS}, heads);"
            f" got {tuple(qkv.shape)}, {tuple(bias.shape)}, "
            f"{tuple(table.shape)}")
    for t, dt in ((qkv, torch.bfloat16), (bias, torch.bfloat16),
                  (table, torch.float32)):
        if t.dtype != dt or t.device != qkv.device:
            raise ValueError(
                "the window attention kernel takes qkv and its bias in "
                "bfloat16 and the table in float32, on one card; got "
                f"{qkv.dtype}, {bias.dtype}, {table.dtype} on {qkv.device}, "
                f"{bias.device}, {table.device}")
    b, h, w, c3 = qkv.shape
    heads = table.shape[1]
    if c3 != 3 * heads * HEAD_DIM:
        raise ValueError(f"head dim {c3 / (3 * heads):g}: the kernel is built "
                         f"for {HEAD_DIM}")
    if not 0 <= shift < WINDOW or shift % 2:
        # an odd shift would cut a thread's pair of adjacent keys in two
        raise ValueError(f"shift {shift}: an even roll of 0 to {WINDOW - 2}")
    sb, sh, sw, sc = qkv.stride()
    if (sc != 1 or sw < c3 or sb % 8 or sh % 8 or sw % 8
            or qkv.data_ptr() % 16 or bias.stride(0) != 1
            or bias.data_ptr() % 16):
        raise ValueError(
            "qkv is read as rows of tokens (strides (sb, sh, sw, 1), each a "
            "multiple of 8 elements, sw at least 3C) from 16-byte aligned "
            f"data and bias; got strides {qkv.stride()}")
    windows = -(-h // WINDOW) * -(-w // WINDOW)
    if b * windows * heads >= 2 ** 31:
        raise ValueError(f"{b} x {windows} x {heads} is too large a launch")
    return b, h, w, c3 // 3, heads


def attention(qkv: torch.Tensor, bias: torch.Tensor, table: torch.Tensor,
              shift: int, scale: float, mask=None) -> torch.Tensor:
    """The window attention of qkv's grid, (B, H, W, C): the kernel on a
    card, `attention_plain` with `mask` on the CPU."""
    global LAUNCHES
    if qkv.device.type == "cpu":
        if mask is None:
            raise ValueError("on the CPU the window attention takes its "
                             "materialised mask")
        return attention_plain(qkv, bias, mask, shift, scale)
    b, h, w, c, heads = _check(qkv, bias, table, shift)
    out = torch.empty((b, h, w, c), dtype=qkv.dtype, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(qkv.device):
        rc = _build.library().iseg_swin_attention(
            qkv.data_ptr(), *qkv.stride()[:3], bias.data_ptr(),
            table.data_ptr(), *table.stride(), b, h, w, c, heads, shift,
            scale, out.data_ptr(), stream)
    _build.check(rc, "swin_attention")
    LAUNCHES += 1
    return out
