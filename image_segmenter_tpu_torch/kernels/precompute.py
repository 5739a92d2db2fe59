"""K2: the matting-Laplacian precompute in one pass.

Replaces image_segmenter_tpu/kernels/pallas_precompute.py (`_kernel` via
`precompute_planes`). For every 3x3 window of an RGB image it computes
the window count and means, the three residual-accumulation moment passes
(closed-form moments cancel in f32; solvers/matting.py), the ridge
eps_w = max(eps, 1e-5 * trace), the LDL pivots' inverses and multipliers,
the rank-deficiency flag, and diag(L) as a member sum. Output plane
order: [i1, i2, i3, l21, l31, l32, diag, n, mu_r, mu_g, mu_b, rankdef].

What bounds K2 on the H100 is its instruction count (about 690 unfused
operations a pixel, 18 of them IEEE divisions; device memory sees 12 bytes
in and 48 out). So in csrc/precompute.cu a warp walks down a strip of
`STRIP` output columns, one row of windows a step, entirely in registers:
a lane loads its own column, gets its neighbours' by warp shuffle, centres
the 27 window values once for all three passes, and hands each member's
diag term to the lane that owns the pixel by shuffle. The grid is strips x
row runs x images; `run_rows` chooses the run so that the card holds no
more than `WARPS_PER_SM` warps for each SM, one wave. The sums keep the
plain version's order, so the kernel matches it bit for bit.

`precompute_planes` routes by device: a CUDA tensor launches
csrc/precompute.cu, a CPU tensor takes `precompute_planes_plain`, the
JAX package's XLA formulation (solvers/matting._precompute with
half_stats, radius 1, f32) in torch. The two agree to f32 rounding: every
entry within 1e-4 in absolute or relative terms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.backend import sm_count, targets_cuda
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process (read by chip_smoke.py)
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

NPLANES = 12
_DELTA = 1e-5  # f32 scale-aware ridge

STRIP = 30           # output columns a warp of K2 walks down (SW there)
# Warps of K2 an SM of the H100 holds at once (blocks of 4 warps, at most
# 128 registers a thread): a grid of at most this many for each SM runs as
# one wave
WARPS_PER_SM = 16
MIN_RUN_ROWS = 8     # a run recomputes 2 centre rows: never shorter than this


def run_rows(h: int, w: int, b: int, sms: int) -> int:
    """Output rows a warp of K2 covers: [0, H) is cut into equal runs, as
    many as keep the grid within `WARPS_PER_SM` warps for each of the
    card's `sms` SMs over `b` images of ceil(w / STRIP) strips."""
    strips = -(-w // STRIP)
    runs = max(1, WARPS_PER_SM * sms // (strips * b))
    return min(h, max(MIN_RUN_ROWS, -(-h // runs)))


def precompute_planes(img: torch.Tensor, epsilon: float) -> torch.Tensor:
    """(B, 3, H, W) float32 image in [0, 1] -> (B, 12, H, W) planes."""
    if img.dim() != 4 or img.shape[1] != 3 or img.dtype != torch.float32:
        raise ValueError("precompute_planes takes (B, 3, H, W) float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if not targets_cuda(img):
        return precompute_planes_plain(img, epsilon)
    global LAUNCHES
    if not img.is_contiguous():
        raise ValueError("precompute_planes: image must be contiguous")
    b, _, h, w = img.shape
    out = torch.empty((b, NPLANES, h, w), dtype=torch.float32,
                      device=img.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(img.device).cuda_stream
    rows = run_rows(h, w, b, sm_count(img.device))
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(img.device):
        rc = lib.iseg_precompute(img.data_ptr(), b, h, w, float(epsilon), rows,
                                 out.data_ptr(), stream)
    _build.check(rc, "precompute")
    LAUNCHES += 1
    return out


def shifts(radius: int = 1):
    return [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]


_SHIFTS = shifts(1)


def _pad1(x: torch.Tensor, fill: float = 0.0, r: int = 1) -> torch.Tensor:
    """Pad H and W by r on all sides; shifted reads become slices."""
    return F.pad(x, (r, r, r, r), value=fill)


def _sl(xp: torch.Tensor, dy: int, dx: int, h: int, w: int,
        r: int = 1) -> torch.Tensor:
    """out[p] = x[p + (dy, dx)] from an r-padded array."""
    return xp[..., r + dy:r + dy + h, r + dx:r + dx + w]


def _box(xp: torch.Tensor, h: int, w: int, r: int = 1) -> torch.Tensor:
    """(2r+1)^2 box sum of a zero-padded array: columns over dx, then rows
    over dy, each summed left to right."""
    cols = xp[..., :, 0:w]
    for k in range(1, 2 * r + 1):
        cols = cols + xp[..., :, k:k + w]
    rows = cols[..., 0:h, :]
    for k in range(1, 2 * r + 1):
        rows = rows + cols[..., k:k + h, :]
    return rows


class WindowFactors(NamedTuple):
    """Per-window statistics of a (B, 3, H, W) image, each (B, H, W) or
    (B, k, H, W)."""
    ldl: torch.Tensor      # (B, 6, H, W) [i1, i2, i3, l21, l31, l32]
    inv: torch.Tensor      # (B, 6, H, W) [inv00, inv01, inv02, inv11, inv12,
                           # inv22] of the symmetric (Sigma + eps/n I)^-1
    diag: torch.Tensor     # diag(L)
    n: torch.Tensor        # window size (== windows covering the pixel)
    mu: torch.Tensor       # (B, 3, H, W) window means
    rankdef: torch.Tensor  # bool: window exactly rank-deficient


def window_factors(img: torch.Tensor, epsilon: float,
                   radius: int = 1) -> WindowFactors:
    """solvers/matting._precompute of the JAX package (its XLA
    formulation), batched, channels first, for any radius, in the image's
    type (float32 or float64).

    The inverse comes from an LDL' factorisation of the unnormalised ridge
    matrix A_k = sum_j d_j d_j' + eps_w I (d_j = I_j - mu_k), whose pivots
    are sums of squares of explicit regression residuals (three passes
    over the window shifts): no cancellation at any conditioning. The
    ridge is scale-aware in float32, eps_w = max(eps, 1e-5 tr(Z'Z)), and
    exactly eps in float64, which exists to be the reference operator.
    """
    b, _, h, w = img.shape
    r = radius
    sh = shifts(r)
    dt = img.dtype
    ones = torch.ones((b, h, w), dtype=dt, device=img.device)
    v_pad = _pad1(ones, r=r)
    img_pad = _pad1(img, r=r)

    n_k = _box(v_pad, h, w, r)
    mu = _box(img_pad, h, w, r) / n_k[:, None]

    def centred(dy, dx):
        v = _sl(v_pad, dy, dx, h, w, r)
        d = (_sl(img_pad, dy, dx, h, w, r) - mu) * v[:, None]
        return v, d[:, 0], d[:, 1], d[:, 2]

    # pass A: first-channel moments -> l21, l31, and the trace for the ridge
    a00 = a01 = a02 = a11 = a22 = torch.zeros_like(n_k)
    for dy, dx in sh:
        _, d0, d1, d2 = centred(dy, dx)
        a00 = a00 + d0 * d0
        a01 = a01 + d0 * d1
        a02 = a02 + d0 * d2
        a11 = a11 + d1 * d1
        a22 = a22 + d2 * d2
    tr = (a00 + a11) + a22
    delta = _DELTA if dt == torch.float32 else 0.0
    eps_w = torch.clamp_min(delta * tr, epsilon)
    p1 = a00 + eps_w
    l21 = a01 / p1
    l31 = a02 / p1

    # pass B: residuals of ch2/ch3 on ch1 -> p2, l32
    q22 = q23 = torch.zeros_like(n_k)
    for dy, dx in sh:
        v, d0, d1, d2 = centred(dy, dx)
        r2 = d1 - l21 * d0
        r3 = d2 - l31 * d0
        q22 = q22 + v * r2 * r2
        q23 = q23 + v * r2 * r3
    p2 = q22 + eps_w * (1.0 + l21 * l21)
    l32 = (q23 + eps_w * l21 * l31) / p2

    # pass C: residual of ch3 on (ch1, ch2) -> p3
    q3 = torch.zeros_like(n_k)
    for dy, dx in sh:
        v, d0, d1, d2 = centred(dy, dx)
        rr = (d2 - l31 * d0) - l32 * (d1 - l21 * d0)
        q3 = q3 + v * rr * rr
    bq = l21 * l32 - l31
    p3 = q3 + eps_w * (bq * bq + l32 * l32 + 1.0)

    rankdef = (q3 < _DELTA * tr) & (tr > 1e-4)

    i1 = n_k / p1
    i2 = n_k / p2
    i3 = n_k / p3
    inv00 = i1 + l21 * l21 * i2 + bq * bq * i3
    inv01 = -l21 * i2 - bq * l32 * i3
    inv02 = bq * i3
    inv11 = i2 + l32 * l32 * i3
    inv12 = -l32 * i3
    inv22 = i3

    # diag(L)_i = n_i - sum_{k in w_i} (1 + (I_i-mu_k)' Dk^-1 (I_i-mu_k))/n_k,
    # reindexed by the window k: g_s(k) reads the member k - s.
    diag_sum = torch.zeros_like(n_k)
    nk_safe = torch.clamp_min(n_k, 1.0)
    for dy, dx in sh:
        d = _sl(img_pad, -dy, -dx, h, w, r) - mu
        d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
        quad = (inv00 * d0 * d0 + inv11 * d1 * d1 + inv22 * d2 * d2
                + 2.0 * (inv01 * d0 * d1 + inv02 * d0 * d2 + inv12 * d1 * d2))
        g = (1.0 + quad) / nk_safe
        diag_sum = diag_sum + _sl(_pad1(g, r=r), dy, dx, h, w, r)
    diag = n_k - diag_sum

    return WindowFactors(
        torch.stack([i1, i2, i3, l21, l31, l32], dim=1),
        torch.stack([inv00, inv01, inv02, inv11, inv12, inv22], dim=1),
        diag, n_k, mu, rankdef)


def precompute_planes_plain(img: torch.Tensor, epsilon: float) -> torch.Tensor:
    """The plain version: solvers/matting._precompute of the JAX package
    (XLA branch, half_stats, radius 1, f32), batched, channels first."""
    f = window_factors(img, epsilon, 1)
    return torch.cat([f.ldl, f.diag[:, None], f.n[:, None], f.mu,
                      f.rankdef.to(torch.float32)[:, None]], dim=1)
