"""SAM's encoder attention with the decomposed relative-position bias, as
one kernel.

Replaces no TPU kernel: the JAX package has no SAM. It takes the library
attention (`F.scaled_dot_product_attention`) and its materialised bias
out of models/sam.Attention's bfloat16 path. csrc/sam_attention.cu says
what bounds it and how it is tiled.

`attention(q, k, v, rel_h, rel_w, scale)`:
- q, k, v (B', heads, n, d): views of the qkv projection, any strides with
  the last 1, read in place;
- rel_h (B' heads, h, w, h) and rel_w (B' heads, h, w, w): the two terms
  of the bias on the h x w token grid (n = h w), as the einsums of
  `Attention.forward` make them;
- returns (B', n, heads d), ready for the output projection.

The bias of query i and key j is rel_h[i, j // w] + rel_w[i, j % w],
rounded to the inputs' type (bfloat16: the configuration's additive
mask) and added to the float32 score q.k * scale; the softmax is float32
and its unnormalised probabilities are rounded to the inputs' type for
the product with v.

A CPU tensor takes `attention_plain`, which does that arithmetic with the
bias materialised in float32 (in float32 it is the formula of
segment-anything's Attention). A CUDA tensor launches the kernel, which
takes bfloat16 on one card, a grid at most 64 wide, strides that are
multiples of 8 elements and 16-byte aligned pointers, and the head dims
it is built for, `HEAD_DIMS`: anything else raises. There is no
fallback.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process; a ViT block is one
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

# the kernel's instantiations: SAM's heads (ViT-B and ViT-L 64, ViT-H 80)
# and the tests' small configuration (16). The kernel takes any multiple
# of 16 up to 128 as 16-wide k-slices; another is one line of the .cu's
# switch, and a second or so of the library's build.
HEAD_DIMS = (16, 64, 80)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rel_h: torch.Tensor, rel_w: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """The kernel's arithmetic with the bias materialised: (B', n, heads d)
    in the inputs' type."""
    b, nh, n, d = q.shape
    _, h, w, _ = rel_h.shape
    dt = q.dtype
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]) \
        .to(dt).float().reshape(b, nh, n, n)
    s = torch.matmul(q.float(), k.float().transpose(-2, -1)) * scale + bias
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(dt).float(), v.float()) / p.sum(-1, keepdim=True)
    return o.to(dt).permute(0, 2, 1, 3).reshape(b, n, nh * d)


def _check(q, k, v, rel_h, rel_w) -> tuple:
    """(B', heads, h, w, d) of operands the kernel takes; raises on any
    other."""
    b, nh, n, d = q.shape
    if rel_h.dim() != 4 or rel_w.dim() != 4:
        raise ValueError("rel_h and rel_w are (B' heads, h, w, h) and "
                         f"(B' heads, h, w, w); got {tuple(rel_h.shape)}, "
                         f"{tuple(rel_w.shape)}")
    _, h, w, _ = rel_h.shape
    if (k.shape != q.shape or v.shape != q.shape
            or rel_h.shape != (b * nh, h, w, h)
            or rel_w.shape != (b * nh, h, w, w) or h * w != n or w > 64):
        # w > 64: a grid row must fit the kernel's 64-key tile
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, rel_h {tuple(rel_h.shape)}, "
            f"rel_w {tuple(rel_w.shape)}")
    for t in (q, k, v, rel_h, rel_w):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError("the attention kernel takes bfloat16 on one "
                             f"card; got {t.dtype} on {t.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    for t in (q, k, v):
        sb, sh, sn, sd = t.stride()
        if (sd != 1 or sh != d or sb != n * sn or sn % 8
                or t.data_ptr() % 16):
            raise ValueError(
                "q, k and v are read as rows of tokens, the heads side by "
                "side (strides (n t, d, t, 1), t a multiple of 8 elements) "
                f"from 16-byte aligned data; got strides {t.stride()}")
    if b * nh * -(-n // 16) >= 2 ** 31:
        raise ValueError(f"{b} x {nh} x {n} is too large a launch")
    return b, nh, h, w, d


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              rel_h: torch.Tensor, rel_w: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v, (B', n, heads d): the kernel on a
    card, `attention_plain` on the CPU."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_plain(q, k, v, rel_h, rel_w, scale)
    b, nh, h, w, d = _check(q, k, v, rel_h, rel_w)
    out = torch.empty((b, h * w, nh * d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(q.device):
        rc = _build.library().iseg_sam_attention(
            q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
            v.data_ptr(), *v.stride()[:3], rel_h.data_ptr(), *rel_h.stride(),
            rel_w.data_ptr(), *rel_w.stride(), b, nh, h, w, d, scale,
            out.data_ptr(), stream)
    _build.check(rc, "sam_attention")
    LAUNCHES += 1
    return out
