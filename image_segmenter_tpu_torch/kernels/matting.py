"""K6: L @ p of the matting Laplacian with the window means recomputed.

Replaces image_segmenter_tpu/kernels/pallas_matting.py (`_kernel` via
`matvec_planes`). Where K3 and K5 read the window count n and the means mu
from precomputed planes, this variant reads only [valid, img x3, f0..f5]
(10 planes, `pack_static`) and the padded p (`pad_p`), and rebuilds n, mu
and pbar inside the tile: 12 planes of traffic a call against K3's 15.

It is not K3 in another layout. It sums `valid` over the window for n,
takes ninv = 1 / max(n, 1) and multiplies by it where K3 divides; builds
mu and pbar from valid * img and valid * p; masks a and b by the centre's
validity; takes the non-separable 9-shift box; and accumulates
box(b) + sum_c box(a_c) * img_c in that order. The two agree to float32
rounding, not to bits.

What bounds K6 on the H100 is device memory (11 planes read and one
written, 0.035-0.038 ms at 4 x 580 x 1152) with its instruction slots close
behind (about 250 float instructions a pixel, none fused). So
csrc/matvec_recompute.cu walks as K3 does: a block goes down a strip of
`STRIP` output columns one row of windows a step, the rows of the eleven
planes arriving in a shared-memory ring through `cp.async` (16-byte
pieces: the padding puts the strip's window on a 16-byte boundary), each
read once per strip; the 3 x 3 windows rotate in registers. Nothing is
summed in another order, so the kernel gives the plain version's bits.
The grid is strips x row runs x images; `run_rows` chooses the run so that
the card holds no more than `BLOCKS_PER_SM` blocks for each SM, one wave.

`matvec_planes` routes by device: a CUDA tensor launches
csrc/matvec_recompute.cu, a CPU tensor takes `matvec_planes_plain`, which
repeats the TPU kernel's arithmetic in its order on the whole padded
planes. Both take an optional leading batch axis; with one image they take
and return what the JAX function does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import _build
# the runs of an image, as K3's grid makes them (K6's grid makes the same)
from image_segmenter_tpu_torch.kernels.matvec import run_bounds  # noqa: F401
from image_segmenter_tpu_torch.kernels.precompute import _SHIFTS
from image_segmenter_tpu_torch.utils.backend import sm_count, targets_cuda
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process (read by chip_smoke.py)
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

NSTATIC = 10  # valid, img x3, f0..f5
HALO = 2      # two stacked radius-1 window passes
_ROW_TILE = 32  # the output has whole row tiles of the TPU kernel's size

STRIP = 124          # output columns a block walks down (SW in the source)
# Blocks of csrc/matvec_recompute.cu an SM of the H100 holds at once: 128
# threads of 96 registers and 36.4 KB of shared memory (cuobjdump
# -res-usage); a grid of at most this many for each SM runs as one wave
BLOCKS_PER_SM = 5
MIN_RUN_ROWS = 8     # a run re-reads 4 rows: never shorter than this


def run_rows(ho: int, wp: int, b: int, sm_count: int) -> int:
    """Output rows a block of K6 covers: [0, Ho) is cut into equal runs,
    as many as keep the grid within `BLOCKS_PER_SM` blocks for each of the
    card's `sm_count` SMs over `b` images of ceil(wp / STRIP) strips."""
    strips = -(-wp // STRIP)
    runs = max(1, BLOCKS_PER_SM * sm_count // (strips * b))
    return min(ho, max(MIN_RUN_ROWS, -(-ho // runs)))


def _aligned_wp(w: int) -> int:
    return -(-(w + 2 * HALO) // 128) * 128


def pad_p(p: torch.Tensor) -> torch.Tensor:
    """Halo-pad the iteration-varying p: (..., H, W) -> (..., H + 4, Wp),
    Wp = W + 4 rounded up to 128."""
    w = p.shape[-1]
    return F.pad(p, (HALO, _aligned_wp(w) - w - HALO, HALO, HALO))


def pack_static(valid: torch.Tensor, image: torch.Tensor,
                factors: torch.Tensor) -> torch.Tensor:
    """Stack and halo-pad the loop-invariant operands once per solve.

    valid (..., H, W), image (..., 3, H, W), factors (..., 6, H, W), all
    float32 -> (..., 10, H + 4, Wp)."""
    return pad_p(torch.cat([valid.unsqueeze(-3), image, factors], dim=-3))


def _out_rows(hp: int) -> int:
    return -(-(hp - 2 * HALO) // _ROW_TILE) * _ROW_TILE


def _check(p_pad: torch.Tensor, static_planes: torch.Tensor) -> None:
    b, hp, wp = p_pad.shape
    if (static_planes.shape != (b, NSTATIC, hp, wp) or hp <= 2 * HALO
            or wp <= 2 * HALO
            or {p_pad.dtype, static_planes.dtype} != {torch.float32}):
        raise ValueError("matvec_planes takes p_pad (B, Hp, Wp) and static "
                         "planes (B, 10, Hp, Wp), float32; got "
                         f"{tuple(p_pad.shape)} {p_pad.dtype}, "
                         f"{tuple(static_planes.shape)} {static_planes.dtype}")


def matvec_planes(p_pad: torch.Tensor,
                  static_planes: torch.Tensor) -> torch.Tensor:
    """q = L p from halo-padded operand planes (K6).

    p_pad (B, Hp, Wp) from `pad_p`, static_planes (B, 10, Hp, Wp) from
    `pack_static` -> (B, nt * 32, Wp) with nt = ceil((Hp - 4) / 32); the
    matvec lives at [:, :H, :W] and the caller slices. Outside it the
    entries are what the TPU kernel leaves there (partial window sums next
    to the image, zeros further out). Without the batch axis: (Hp, Wp),
    (10, Hp, Wp) -> (nt * 32, Wp)."""
    if p_pad.dim() == 2:
        return matvec_planes(p_pad[None], static_planes[None])[0]
    _check(p_pad, static_planes)
    if not targets_cuda(p_pad):
        return matvec_planes_plain(p_pad, static_planes)
    global LAUNCHES
    if not static_planes.is_cuda:
        raise ValueError("matvec_planes: all operands must be on the card")
    if not (p_pad.is_contiguous() and static_planes.is_contiguous()):
        raise ValueError("matvec_planes: operands must be contiguous")
    b, hp, wp = p_pad.shape
    ho = _out_rows(hp)
    out = torch.empty((b, ho, wp), dtype=torch.float32, device=p_pad.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(p_pad.device).cuda_stream
    rows = run_rows(ho, wp, b, sm_count(p_pad.device))
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(p_pad.device):
        rc = lib.iseg_matvec_recompute(p_pad.data_ptr(),
                                       static_planes.data_ptr(), b, hp, wp,
                                       ho, rows, out.data_ptr(), stream)
    _build.check(rc, "matvec_recompute")
    LAUNCHES += 1
    return out


def matvec_planes_plain(p_pad: torch.Tensor,
                        static_planes: torch.Tensor) -> torch.Tensor:
    """The plain version of K6: the TPU kernel's two passes on the whole
    padded planes instead of row tiles (each output depends only on its
    5 x 5 neighbourhood, so the tiling does not change a float)."""
    if p_pad.dim() == 2:
        return matvec_planes_plain(p_pad[None], static_planes[None])[0]
    _check(p_pad, static_planes)
    b, hp, wp = p_pad.shape
    ho = _out_rows(hp)
    # rows below the planes read as zeros, as the TPU kernel's padded tail
    p = F.pad(p_pad, (0, 0, 0, ho + 2 * HALO - hp))
    st = F.pad(static_planes, (0, 0, 0, ho + 2 * HALO - hp))
    v = st[:, 0]
    img = st[:, 1:4]
    tc, wc = ho + 2, wp - 2

    def ctr(x, dy=0, dx=0):
        return x[..., 1 + dy:1 + dy + tc, 1 + dx:1 + dx + wc]

    # ---- pass 1: per-centre window stats and (a, b) -----------------------
    n = torch.zeros((b, tc, wc), dtype=torch.float32, device=p.device)
    for dy, dx in _SHIFTS:
        n = n + ctr(v, dy, dx)
    ninv = 1.0 / torch.clamp_min(n, 1.0)

    vp = v * p
    s = torch.zeros((b, 3, tc, wc), dtype=torch.float32, device=p.device)
    for dy, dx in _SHIFTS:
        s = s + ctr(v, dy, dx)[:, None] * ctr(img, dy, dx)
    mu = s * ninv[:, None]
    pbar = torch.zeros_like(n)
    for dy, dx in _SHIFTS:
        pbar = pbar + ctr(vp, dy, dx)
    pbar = pbar * ninv

    cov = torch.zeros_like(mu)
    for dy, dx in _SHIFTS:
        cov = cov + (ctr(img, dy, dx) - mu) * ctr(vp, dy, dx)[:, None]

    i1, i2, i3, l21, l31, l32 = ctr(st[:, 4:10]).unbind(1)
    bq = l21 * l32 - l31
    c = cov * ninv[:, None]
    c0, c1, c2 = c[:, 0], c[:, 1], c[:, 2]
    t1 = c1 - l21 * c0
    t2 = bq * c0 - l32 * c1 + c2
    w0 = i1 * c0
    w1 = i2 * t1
    w2 = i3 * t2
    a0 = w0 - l21 * w1 + bq * w2
    a1 = w1 - l32 * w2
    a2 = w2
    bsc = pbar - (a0 * mu[:, 0] + a1 * mu[:, 1] + a2 * mu[:, 2])

    # only real windows (centre pixel in-bounds) contribute
    vc = ctr(v)
    a0, a1, a2, bsc = a0 * vc, a1 * vc, a2 * vc, bsc * vc

    # ---- pass 2: box-sum (a, b) over the covering windows -----------------
    wo = wp - 4

    def boxc(x):
        acc = torch.zeros((b, ho, wo), dtype=torch.float32, device=p.device)
        for dy, dx in _SHIFTS:
            acc = acc + x[:, 1 + dy:1 + dy + ho, 1 + dx:1 + dx + wo]
        return acc

    acc = boxc(bsc)
    for ch, ac in enumerate((a0, a1, a2)):
        acc = acc + boxc(ac) * img[:, ch, 2:2 + ho, 2:2 + wo]
    q = n[:, 1:1 + ho, 1:1 + wo] * p[:, 2:2 + ho, 2:2 + wo] - acc
    return F.pad(q, (0, 4))
