"""K3 and K5: one matvec L @ p of the matting Laplacian, the CG hot loop.

Replaces image_segmenter_tpu/kernels/pallas_matvec.py (`_kernel_tiled`,
math in `_compute_tile`, via `matvec_planes_tiled`). Per 3x3 window k:
the box sum of p, the covariance of p with the centred image, the
packed-LDL solve a_k = Dk^-1 cov_k / n_k, b_k = pbar_k - a_k . mu_k; then
per pixel i: (L p)_i = n_i p_i - (sum_k a_k . I_i + b_k) over the windows
covering i. Windows centred outside the image contribute nothing.

It reads K2's (B, 12, H, W) planes, the (B, 3, H, W) image and p
(B, H, W) directly: no overlap-tiled operand stack, no lane padding. The
TPU kernel needed those for its tile memory; a CUDA block loads its own
halo.

What bounds K3 on the H100 is device memory (15 planes moved a call, 42
us at 4 x 576 x 1024) with the instruction slots close behind (about 370
instructions a pixel with `--fmad=false`). So csrc/matvec.cu makes each
block walk down a strip of `STRIP` output columns, one row of windows a
step: rows of the operands arrive in shared-memory rings through
`cp.async`, two rows ahead of the arithmetic, each read once per strip
(aligned 16-byte pieces where W is a multiple of 4), and the sums over
columns are carried down the strip in registers. The grid is strips x row
runs x images; `run_rows` chooses the run so that the card holds
no more than `BLOCKS_PER_SM` blocks for each SM, one wave (a run re-reads
4 rows at its top, so longer is cheaper and shorter fills the card). The sums keep the plain
version's order, so the kernel matches it bit for bit.

`matvec_planes` routes by device: a CUDA tensor launches csrc/matvec.cu,
a CPU tensor takes `matvec_planes_plain`, the JAX package's
solvers/matting._matvec (packed factors, radius 1, f32) in torch. The two
agree to max|diff| / max|ref| < 1e-5.

K5, `matvec_stack`, is the same L @ p read from the untiled zero-padded
(B, 13, Hp, Wp) operand stack [n, mu x3, i1, i2, i3, l21, l31, l32,
img x3] that `build_matvec_stack` assembles once per solve. It replaces
the manual-DMA variant of the same file (`_kernel` via `matvec_planes`
there). A CUDA tensor launches csrc/matvec_stack.cu; a CPU tensor takes
`matvec_stack_plain`, which repeats that kernel's arithmetic in its order
on the whole padded stack.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels.precompute import NPLANES, _SHIFTS, \
    _box, _pad1, _sl, shifts
from image_segmenter_tpu_torch.utils.backend import sm_count, targets_cuda
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# K3 launches in this process (read by chip_smoke.py)
LAUNCHES = replayed_counter(__name__, "LAUNCHES")
# K5 launches in this process
STACK_LAUNCHES = replayed_counter(__name__, "STACK_LAUNCHES")

NSTACK = 13   # planes of K5's operand stack
HALO = 2      # member box needs windows at +-1, windows need p at +-1
# The stack's padded size is the layout the TPU kernel fixed (row tiles of
# 32 plus 8 rows of load slack, columns to a multiple of 128); it is kept
# so that stacks built by either package are interchangeable.
_ROW_TILE = 32
_ROW_EXTRA = 8

STRIP = 128          # output columns a block of K3 walks down (SW there)
# Blocks of K3 an SM of the H100 holds at once (160 threads of 110
# registers): a grid of at most this many for each SM runs as one wave, and
# a few blocks more cost a second one
BLOCKS_PER_SM = 3
MIN_RUN_ROWS = 8     # a run re-reads 4 rows: never shorter than this


def run_rows(h: int, w: int, b: int, sm_count: int) -> int:
    """Output rows a block of K3 covers: [0, H) is cut into equal runs,
    as many as keep the grid within `BLOCKS_PER_SM` blocks for each of the
    card's `sm_count` SMs over `b` images of ceil(w / STRIP) strips."""
    strips = -(-w // STRIP)
    runs = max(1, BLOCKS_PER_SM * sm_count // (strips * b))
    return min(h, max(MIN_RUN_ROWS, -(-h // runs)))


def run_bounds(h: int, rows: int) -> list:
    """The (first, past-last) output rows of the runs K3's grid makes of
    an image of `h` rows."""
    return [(r0, min(r0 + rows, h)) for r0 in range(0, h, rows)]


def matvec_planes(planes: torch.Tensor, img: torch.Tensor,
                  p: torch.Tensor) -> torch.Tensor:
    """L @ p. planes (B, 12, H, W), img (B, 3, H, W), p (B, H, W), all
    float32 -> (B, H, W) float32."""
    b, h, w = p.shape
    if (planes.shape != (b, NPLANES, h, w) or img.shape != (b, 3, h, w)
            or {planes.dtype, img.dtype, p.dtype} != {torch.float32}):
        raise ValueError("matvec_planes takes (B, 12, H, W), (B, 3, H, W) "
                         "and (B, H, W) float32; got "
                         f"{tuple(planes.shape)}, {tuple(img.shape)}, "
                         f"{tuple(p.shape)}")
    if not targets_cuda(p):
        return matvec_planes_plain(planes, img, p)
    global LAUNCHES
    if not (planes.is_cuda and img.is_cuda):
        raise ValueError("matvec_planes: all operands must be on the card")
    if not (planes.is_contiguous() and img.is_contiguous()
            and p.is_contiguous()):
        raise ValueError("matvec_planes: operands must be contiguous")
    out = torch.empty_like(p)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rows = run_rows(h, w, b, sm_count(p.device))
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(p.device):
        rc = lib.iseg_matvec(planes.data_ptr(), img.data_ptr(), p.data_ptr(),
                             b, h, w, rows, out.data_ptr(), stream)
    _build.check(rc, "matvec")
    LAUNCHES += 1
    return out


def laplacian_matvec_plain(img: torch.Tensor, n_k: torch.Tensor,
                           mu: torch.Tensor, dinv: torch.Tensor,
                           p: torch.Tensor, radius: int = 1,
                           packed: bool = True) -> torch.Tensor:
    """solvers/matting._matvec of the JAX package, batched, channels
    first, in the operands' type. img (B, 3, H, W), n_k (B, H, W), mu
    (B, 3, H, W), p (B, H, W); dinv (B, 6, H, W) holds the packed LDL
    factors [i1, i2, i3, l21, l31, l32] (`packed`) or the entries [00,
    01, 02, 11, 12, 22] of the symmetric window inverse."""
    b, h, w = p.shape
    r = radius
    p_pad = _pad1(p, r=r)
    img_pad = _pad1(img, r=r)

    psum = _box(p_pad, h, w, r)
    pbar = psum / n_k
    # centred covariance sum_j (I_j - mu_k) p_j; out-of-image p_j are 0
    cov = torch.zeros_like(mu)
    for dy, dx in shifts(r):
        vp = _sl(p_pad, dy, dx, h, w, r)
        cov = cov + (_sl(img_pad, dy, dx, h, w, r) - mu) * vp[:, None]
    v = cov / n_k[:, None]
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    if packed:
        # dinv @ v from the packed factors (_matvec3_fact)
        i1, i2, i3, l21, l31, l32 = dinv.unbind(1)
        bq = l21 * l32 - l31
        t1 = v1 - l21 * v0
        t2 = bq * v0 - l32 * v1 + v2
        w0 = i1 * v0
        w1 = i2 * t1
        w2 = i3 * t2
        a = torch.stack([w0 - l21 * w1 + bq * w2, w1 - l32 * w2, w2], dim=1)
    else:
        d00, d01, d02, d11, d12, d22 = dinv.unbind(1)
        a = torch.stack([d00 * v0 + d01 * v1 + d02 * v2,
                         d01 * v0 + d11 * v1 + d12 * v2,
                         d02 * v0 + d12 * v1 + d22 * v2], dim=1)
    bb = pbar - ((a[:, 0] * mu[:, 0] + a[:, 1] * mu[:, 1]) + a[:, 2] * mu[:, 2])

    bs_a = _box(_pad1(a, r=r), h, w, r)
    bs_b = _box(_pad1(bb, r=r), h, w, r)
    return n_k * p - (((bs_a[:, 0] * img[:, 0] + bs_a[:, 1] * img[:, 1])
                       + bs_a[:, 2] * img[:, 2]) + bs_b)


def matvec_planes_plain(planes: torch.Tensor, img: torch.Tensor,
                        p: torch.Tensor) -> torch.Tensor:
    """The plain version: solvers/matting._matvec of the JAX package with
    packed LDL factors, radius 1, from K2's planes."""
    return laplacian_matvec_plain(img, planes[:, 7], planes[:, 8:11],
                                  planes[:, 0:6], p)


def _stack_hw(h: int, w: int) -> tuple:
    """Padded (Hp, Wp) of the operand stack of an (H, W) image."""
    return (-(-h // _ROW_TILE) * _ROW_TILE + _ROW_EXTRA,
            -(-(w + 2 * HALO) // 128) * 128)


def _stack_pad(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last two axes (H, W) to (Hp, Wp), the image at offset
    (HALO, HALO)."""
    h, w = x.shape[-2:]
    hp, wp = _stack_hw(h, w)
    return F.pad(x.to(torch.float32),
                 (HALO, wp - w - HALO, HALO, hp - h - HALO))


def build_matvec_stack(image: torch.Tensor, n: torch.Tensor,
                       mu: torch.Tensor, dinv6: torch.Tensor) -> torch.Tensor:
    """Assemble K5's loop-invariant operand stack once per solve.

    image (B, 3, H, W), n (B, H, W), mu (B, 3, H, W), dinv6 (B, 6, H, W)
    packed LDL factors -> (B, 13, Hp, Wp) zero-padded planes
    [n, mu x3, i1, i2, i3, l21, l31, l32, img x3]."""
    return torch.cat([_stack_pad(n[:, None]), _stack_pad(mu),
                      _stack_pad(dinv6), _stack_pad(image)], dim=1)


def build_matvec_stack_planes(image: torch.Tensor,
                              planes: torch.Tensor) -> torch.Tensor:
    """`build_matvec_stack` straight from K2's (B, 12, H, W) planes: the
    same planes in the same order, so the same bytes."""
    return torch.cat([_stack_pad(planes[:, 7:11]), _stack_pad(planes[:, 0:6]),
                      _stack_pad(image)], dim=1)


def _check_stack(stack: torch.Tensor, p: torch.Tensor) -> None:
    b, h, w = p.shape
    if (stack.dim() != 4 or stack.shape[0] != b or stack.shape[1] != NSTACK
            or stack.shape[2] < h + 2 * HALO or stack.shape[3] < w + 2 * HALO
            or {stack.dtype, p.dtype} != {torch.float32}):
        raise ValueError("matvec_stack takes a (B, 13, Hp, Wp) stack with "
                         "Hp >= H + 4, Wp >= W + 4 and p (B, H, W), float32; "
                         f"got {tuple(stack.shape)} {stack.dtype}, "
                         f"{tuple(p.shape)} {p.dtype}")


def matvec_stack(stack: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """L @ p from the padded operand stack (K5). stack (B, 13, Hp, Wp),
    p (B, H, W) -> (B, H, W); or one image: (13, Hp, Wp), (H, W) -> (H, W)."""
    if p.dim() == 2:
        return matvec_stack(stack[None], p[None])[0]
    _check_stack(stack, p)
    if not targets_cuda(p):
        return matvec_stack_plain(stack, p)
    global STACK_LAUNCHES
    if not stack.is_cuda:
        raise ValueError("matvec_stack: all operands must be on the card")
    if not (stack.is_contiguous() and p.is_contiguous()):
        raise ValueError("matvec_stack: operands must be contiguous")
    b, h, w = p.shape
    out = torch.empty_like(p)
    lib = _build.library()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(p.device):
        rc = lib.iseg_matvec_stack(stack.data_ptr(), p.data_ptr(), b, h, w,
                                   stack.shape[2], stack.shape[3],
                                   out.data_ptr(), stream)
    _build.check(rc, "matvec_stack")
    STACK_LAUNCHES += 1
    return out


def matvec_stack_plain(stack: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The plain version of K5: the TPU kernel's `_compute_tile` on the
    whole padded stack instead of row tiles (each output depends only on
    its 5 x 5 neighbourhood, so the tiling does not change a float).
    Windows on the centre grid (halo 1), members on the output grid
    (halo 2); out-of-image windows are masked by n > 0."""
    if p.dim() == 2:
        return matvec_stack_plain(stack[None], p[None])[0]
    _check_stack(stack, p)
    b, h, w = p.shape
    hp, wp = stack.shape[2:]
    pp = F.pad(p, (HALO, wp - w - HALO, HALO, hp - h - HALO))
    n = stack[:, 0]
    mu = stack[:, 1:4]
    img = stack[:, 10:13]
    tc, wc = hp - 2, wp - 2

    def ctr(x, dy=0, dx=0):
        return x[..., 1 + dy:1 + dy + tc, 1 + dx:1 + dx + wc]

    cols_p = (pp[..., 0:wc] + pp[..., 1:1 + wc]) + pp[..., 2:2 + wc]
    psum = (cols_p[:, 0:tc] + cols_p[:, 1:1 + tc]) + cols_p[:, 2:2 + tc]
    nk = ctr(n)
    n_div = torch.clamp_min(nk, 1.0)
    pbar = psum / n_div
    muc = ctr(mu)
    cov = torch.zeros_like(muc)
    for dy, dx in _SHIFTS:
        cov = cov + (ctr(img, dy, dx) - muc) * ctr(pp, dy, dx)[:, None]
    ki1, ki2, ki3, kl21, kl31, kl32 = ctr(stack[:, 4:10]).unbind(1)
    bq = kl21 * kl32 - kl31
    v = cov / n_div[:, None]
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    t1 = v1 - kl21 * v0
    t2 = bq * v0 - kl32 * v1 + v2
    w0 = ki1 * v0
    w1 = ki2 * t1
    w2 = ki3 * t2
    a0 = w0 - kl21 * w1 + bq * w2
    a1 = w1 - kl32 * w2
    a2 = w2
    bb = pbar - ((a0 * muc[:, 0] + a1 * muc[:, 1]) + a2 * muc[:, 2])
    bb = torch.where(nk > 0.0, bb, 0.0)

    to, wo = hp - 4, wp - 4

    def member_box(x):
        cols = (x[..., 0:wo] + x[..., 1:1 + wo]) + x[..., 2:2 + wo]
        return (cols[:, 0:to] + cols[:, 1:1 + to]) + cols[:, 2:2 + to]

    bs_a = [member_box(a) for a in (a0, a1, a2)]
    bs_b = member_box(bb)
    pix = img[..., 2:2 + to, 2:2 + wo]
    out = n[:, 2:2 + to, 2:2 + wo] * pp[:, 2:2 + to, 2:2 + wo] \
        - (((bs_a[0] * pix[:, 0] + bs_a[1] * pix[:, 1])
            + bs_a[2] * pix[:, 2]) + bs_b)
    return out[:, :h, :w].contiguous()
