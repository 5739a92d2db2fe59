"""The main path's stages after the CNN in plain PyTorch: the reference.

A frozen copy of the port's plain paths (the versions its kernels are
held to, which its CPU run executes), so that the yardstick stays as it
is when the program changes: `ops/resize`, `ops/scan.cumsum` and
`tree_sum`, `ops/histogram` (u8 quantiles, Otsu), `ops/morphology`'s
binary close and open, `kernels/precompute.window_factors` and
`kernels/matvec.laplacian_matvec_plain` (radius 1, packed LDL factors),
`solvers/matting.CGLoop` (one batched CG, written one iteration at a
time), `solvers/kmeans.kmeans_fit_det`, `kernels/quantize.
quantize_map_plain`, and `pipeline/segment`'s trimap, grid sample and
stage order. The histogram is `torch.bincount`, exact as the port's
compare-reduce is.

`lowp=True` is the control, one step below the configuration's float32:
the matting planes and the CG's vectors x, r and p are stored in bfloat16
(rounded after every write), and so are the k-means centres after each
Lloyd update.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

AREA = "area"
LINEAR = "linear"
LANCZOS_PIL = "lanczos_pil"


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded as one float division on every device (a CUDA kernel
    divides by a Python scalar as x * (1 / s))."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


# ---------------------------------------------------------------------------
# resize (cv2 / PIL sampling, float64 contractions rounded once)
# ---------------------------------------------------------------------------

def _pil_filter_row(dst: int, src: int, support: float, f) -> np.ndarray:
    w = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    filterscale = max(scale, 1.0)
    sup = support * filterscale
    ss = 1.0 / filterscale
    for d in range(dst):
        center = (d + 0.5) * scale
        xmin = max(0, int(center - sup + 0.5))
        xmax = min(src, int(center + sup + 0.5))
        ws = np.array([f((x - center + 0.5) * ss) for x in range(xmin, xmax)])
        tot = ws.sum()
        if tot != 0:
            w[d, xmin:xmax] = ws / tot
    return w.astype(np.float32)


def _lanczos3(x: float) -> float:
    if x == 0.0:
        return 1.0
    if abs(x) >= 3.0:
        return 0.0
    px = np.pi * x
    return 3.0 * np.sin(px) * np.sin(px / 3.0) / (px * px)


@functools.lru_cache(maxsize=None)
def _weights(src: int, dst: int, method: str) -> np.ndarray:
    """(dst, src) row-stochastic resampling weights, float32."""
    w = np.zeros((dst, src), dtype=np.float32)
    scale = src / dst
    if method == AREA:
        for d in range(dst):
            lo, hi = d * scale, (d + 1) * scale
            s0, s1 = int(np.floor(lo)), int(np.ceil(hi))
            for s in range(s0, min(s1, src)):
                overlap = min(hi, s + 1) - max(lo, s)
                if overlap > 0:
                    w[d, s] = overlap / scale
    elif method == LINEAR:
        for d in range(dst):
            x = (d + 0.5) * scale - 0.5
            x0 = int(np.floor(x))
            f = x - x0
            a = np.clip(x0, 0, src - 1)
            b = np.clip(x0 + 1, 0, src - 1)
            w[d, a] += 1.0 - f
            w[d, b] += f
    elif method == LANCZOS_PIL:
        return _pil_filter_row(dst, src, 3.0, _lanczos3)
    else:
        raise ValueError(f"unknown resize method: {method}")
    return w


def resize_u8(img: torch.Tensor, dst_hw, method: str) -> torch.Tensor:
    """A (B, H, W) or (B, H, W, C) u8 batch resized to dst_hw, rounded half
    up to u8."""
    b, h, w = img.shape[:3]
    tail = img.shape[3:]
    dh, dw = int(dst_hw[0]), int(dst_hw[1])
    if (h, w) == (dh, dw):
        x = img.to(torch.float32)
    else:
        x = img.to(torch.float64)
        wy = torch.from_numpy(_weights(h, dh, method)).to(x.device,
                                                          torch.float64)
        wx = torch.from_numpy(_weights(w, dw, method)).to(x.device,
                                                          torch.float64)
        x = torch.matmul(wy, x.reshape(b, h, -1))
        c = x.shape[-1] // w
        x = x.reshape(b * dh, w, c).transpose(1, 2).reshape(-1, w)
        x = torch.matmul(x, wx.t()).to(torch.float32)
        x = x.reshape(b * dh, c, dw).transpose(1, 2).reshape(b, dh, dw, *tail)
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def scale_to_max_dim(h: int, w: int, max_dim: int) -> tuple:
    scale = min(max_dim / h, max_dim / w)
    return max(1, int(h * scale)), max(1, int(w * scale))


# ---------------------------------------------------------------------------
# fixed-order sums, histograms, quantiles, Otsu
# ---------------------------------------------------------------------------

_BLOCK = 16


def _sequential(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in XLA's CPU order:
    sequential inside blocks of 16, the block totals scanned alike."""
    n = x.shape[-1]
    if n <= _BLOCK:
        return _sequential(x)
    m = -(-n // _BLOCK) * _BLOCK
    xp = F.pad(x, (0, m - n))
    inner = _sequential(xp.reshape(*x.shape[:-1], m // _BLOCK, _BLOCK))
    totals = cumsum(inner[..., -1])
    carry = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                      dim=-1)
    return (inner + carry[..., None]).reshape(*x.shape[:-1], m)[..., :n]


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by pairwise halving (zero-padded to even)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = F.pad(x, (0, 1))
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def histogram_u8(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) u8 -> (B, 256) float32 exact counts per image."""
    flat = x.reshape(x.shape[0], -1).to(torch.int64)
    return torch.stack([torch.bincount(r, minlength=256) for r in flat]) \
        .to(torch.float32)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _quantile_of_hist(hist: torch.Tensor, q: float) -> torch.Tensor:
    n = hist.sum(dim=-1)
    cum = cumsum(hist)
    rank = q * (n - 1.0)
    lo_r = torch.floor(rank)
    frac = rank - lo_r
    v_lo = _first_true(cum > lo_r[:, None])
    v_hi = _first_true(cum > (lo_r + 1.0)[:, None])
    v_hi = torch.where(cum[:, -1] > lo_r + 1.0, v_hi, v_lo)
    return v_lo.to(torch.float32) + frac * (v_hi - v_lo).to(torch.float32)


def otsu_threshold(x: torch.Tensor) -> torch.Tensor:
    """cv2's Otsu threshold per image (ties to the smallest t), (B,)."""
    hist = histogram_u8(x)
    total = hist.sum(dim=-1, keepdim=True)
    bins = torch.arange(256, dtype=torch.float32, device=x.device)
    w0 = cumsum(hist)
    sum0 = cumsum(hist * bins)
    sum_all = sum0[:, -1:]
    w1 = total - w0
    mu0 = torch.where(w0 > 0, sum0 / torch.clamp_min(w0, 1.0), 0.0)
    mu1 = torch.where(w1 > 0, (sum_all - sum0) / torch.clamp_min(w1, 1.0),
                      0.0)
    dmu = mu0 - mu1
    sigma_b = w0 * w1 * (dmu * dmu)
    valid = (w0 > 0) & (w1 > 0)
    sigma_b = torch.where(valid, sigma_b, -1.0)
    return torch.argmax(sigma_b, dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# binary morphology (cv2 semantics), 3 x 3 ellipse
# ---------------------------------------------------------------------------

def ellipse3() -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (3, 3))."""
    kh = kw = 3
    se = np.zeros((kh, kw), dtype=np.uint8)
    r, c = kh // 2, kw // 2
    inv_r2 = 1.0 / (r * r)
    for i in range(kh):
        dy = i - r
        dx = int(round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
        se[i, max(c - dx, 0):min(c + dx + 1, kw)] = 1
    return se


def _shift_reduce(m: torch.Tensor, se: np.ndarray, dilate: bool):
    kh, kw = se.shape
    cy, cx = kh // 2, kw // 2
    b, h, w = m.shape
    py, px = max(cy, kh - 1 - cy), max(cx, kw - 1 - cx)
    mp = torch.full((b, h + 2 * py, w + 2 * px), not dilate,
                    dtype=torch.bool, device=m.device)
    mp[:, py:py + h, px:px + w] = m
    out = None
    for i in range(kh):
        for j in range(kw):
            if not se[i, j]:
                continue
            s = mp[:, py + i - cy:py + i - cy + h, px + j - cx:px + j - cx + w]
            if out is None:
                out = s.clone()
            elif dilate:
                out |= s
            else:
                out &= s
    return out


def sharp_alpha(alpha_u8: torch.Tensor) -> torch.Tensor:
    """Otsu, then a 3 x 3 ellipse close and open -> (B, H, W) bool."""
    t = otsu_threshold(alpha_u8)[:, None, None]
    m = alpha_u8.to(torch.float32) > t
    se = ellipse3()
    m = _shift_reduce(_shift_reduce(m, se, True), se, False)      # close
    return _shift_reduce(_shift_reduce(m, se, False), se, True)   # open


def trimap(alpha_init: torch.Tensor) -> torch.Tensor:
    """The reference trimap ladder per image of a (B, H, W) u8 batch ->
    (B, H, W) float32 in {0, 0.5, 1}."""
    a = alpha_init.to(torch.float32)
    contrast = (a.amax(dim=(1, 2)) - a.amin(dim=(1, 2))) > 50
    hist = histogram_u8(alpha_init)
    q_hi, q_lo = _quantile_of_hist(hist, 0.8), _quantile_of_hist(hist, 0.2)
    hi_t = torch.where(contrast, 220.0, q_hi)[:, None, None]
    lo_t = torch.where(contrast, 20.0, q_lo)[:, None, None]
    tri = torch.full_like(a, 0.5)
    tri = torch.where(a >= hi_t, 1.0, tri)
    tri = torch.where(a <= lo_t, 0.0, tri)
    need_fb = ((tri == 1.0).sum(dim=(1, 2)) == 0) \
        | ((tri == 0.0).sum(dim=(1, 2)) == 0)
    fb = torch.where(a >= 128, 1.0, 0.0)
    return torch.where(need_fb[:, None, None], fb, tri)


# ---------------------------------------------------------------------------
# closed-form matting: window factors, L @ p, the batched CG
# ---------------------------------------------------------------------------

_SHIFTS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
_DELTA = 1e-5
_LAMBDA = 100.0


def _pad1(x):
    return F.pad(x, (1, 1, 1, 1))


def _sl(xp, dy, dx, h, w):
    return xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _box(xp, h, w):
    cols = xp[..., :, 0:w]
    for k in (1, 2):
        cols = cols + xp[..., :, k:k + w]
    rows = cols[..., 0:h, :]
    for k in (1, 2):
        rows = rows + cols[..., k:k + h, :]
    return rows


def window_planes(img: torch.Tensor, epsilon: float) -> torch.Tensor:
    """(B, 3, H, W) float32 -> (B, 12, H, W): [i1, i2, i3, l21, l31, l32,
    diag, n, mu_r, mu_g, mu_b, rankdef] of the radius-1 windows (the
    scale-aware float32 ridge eps_w = max(eps, 1e-5 tr))."""
    b, _, h, w = img.shape
    ones = torch.ones((b, h, w), dtype=img.dtype, device=img.device)
    v_pad = _pad1(ones)
    img_pad = _pad1(img)
    n_k = _box(v_pad, h, w)
    mu = _box(img_pad, h, w) / n_k[:, None]

    def centred(dy, dx):
        v = _sl(v_pad, dy, dx, h, w)
        d = (_sl(img_pad, dy, dx, h, w) - mu) * v[:, None]
        return v, d[:, 0], d[:, 1], d[:, 2]

    a00 = a01 = a02 = a11 = a22 = torch.zeros_like(n_k)
    for dy, dx in _SHIFTS:
        _, d0, d1, d2 = centred(dy, dx)
        a00 = a00 + d0 * d0
        a01 = a01 + d0 * d1
        a02 = a02 + d0 * d2
        a11 = a11 + d1 * d1
        a22 = a22 + d2 * d2
    tr = (a00 + a11) + a22
    eps_w = torch.clamp_min(_DELTA * tr, epsilon)
    p1 = a00 + eps_w
    l21 = a01 / p1
    l31 = a02 / p1
    q22 = q23 = torch.zeros_like(n_k)
    for dy, dx in _SHIFTS:
        v, d0, d1, d2 = centred(dy, dx)
        r2 = d1 - l21 * d0
        r3 = d2 - l31 * d0
        q22 = q22 + v * r2 * r2
        q23 = q23 + v * r2 * r3
    p2 = q22 + eps_w * (1.0 + l21 * l21)
    l32 = (q23 + eps_w * l21 * l31) / p2
    q3 = torch.zeros_like(n_k)
    for dy, dx in _SHIFTS:
        v, d0, d1, d2 = centred(dy, dx)
        rr = (d2 - l31 * d0) - l32 * (d1 - l21 * d0)
        q3 = q3 + v * rr * rr
    bq = l21 * l32 - l31
    p3 = q3 + eps_w * (bq * bq + l32 * l32 + 1.0)
    rankdef = (q3 < _DELTA * tr) & (tr > 1e-4)
    i1, i2, i3 = n_k / p1, n_k / p2, n_k / p3
    inv00 = i1 + l21 * l21 * i2 + bq * bq * i3
    inv01 = -l21 * i2 - bq * l32 * i3
    inv02 = bq * i3
    inv11 = i2 + l32 * l32 * i3
    inv12 = -l32 * i3
    inv22 = i3
    diag_sum = torch.zeros_like(n_k)
    nk_safe = torch.clamp_min(n_k, 1.0)
    for dy, dx in _SHIFTS:
        d = _sl(img_pad, -dy, -dx, h, w) - mu
        d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
        quad = (inv00 * d0 * d0 + inv11 * d1 * d1 + inv22 * d2 * d2
                + 2.0 * (inv01 * d0 * d1 + inv02 * d0 * d2 + inv12 * d1 * d2))
        g = (1.0 + quad) / nk_safe
        diag_sum = diag_sum + _sl(_pad1(g), dy, dx, h, w)
    diag = n_k - diag_sum
    return torch.cat([torch.stack([i1, i2, i3, l21, l31, l32, diag, n_k],
                                  dim=1), mu,
                      rankdef.to(torch.float32)[:, None]], dim=1)


def laplacian_matvec(img, n_k, mu, ldl, p):
    """L @ p of the radius-1 matting Laplacian from packed LDL factors."""
    b, h, w = p.shape
    p_pad = _pad1(p)
    img_pad = _pad1(img)
    pbar = _box(p_pad, h, w) / n_k
    cov = torch.zeros_like(mu)
    for dy, dx in _SHIFTS:
        vp = _sl(p_pad, dy, dx, h, w)
        cov = cov + (_sl(img_pad, dy, dx, h, w) - mu) * vp[:, None]
    v = cov / n_k[:, None]
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    i1, i2, i3, l21, l31, l32 = ldl.unbind(1)
    bq = l21 * l32 - l31
    t1 = v1 - l21 * v0
    t2 = bq * v0 - l32 * v1 + v2
    w0 = i1 * v0
    w1 = i2 * t1
    w2 = i3 * t2
    a = torch.stack([w0 - l21 * w1 + bq * w2, w1 - l32 * w2, w2], dim=1)
    bb = pbar - ((a[:, 0] * mu[:, 0] + a[:, 1] * mu[:, 1]) + a[:, 2] * mu[:, 2])
    bs_a = _box(_pad1(a), h, w)
    bs_b = _box(_pad1(bb), h, w)
    return n_k * p - (((bs_a[:, 0] * img[:, 0] + bs_a[:, 1] * img[:, 1])
                       + bs_a[:, 2] * img[:, 2]) + bs_b)


def _bsum(x: torch.Tensor) -> torch.Tensor:
    """Per-image sum, accumulated in float64 and rounded once."""
    return x.sum(dim=(1, 2), dtype=torch.float64).to(x.dtype)


def _bw(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(m[:, None, None], a, b)


def cg_solve(image01, tri, x0, rtol: float, max_iter: int, lowp: bool,
             epsilon: float = 1e-7, lam: float = _LAMBDA):
    """Solve (L + lam C) alpha = lam known_fg per image by Jacobi-
    preconditioned CG warm-started at x0; each image stops at its own
    relative residual rtol or at max_iter. -> (alpha in [0, 1] (B, H, W),
    iterations (B,))."""
    img = image01.permute(0, 3, 1, 2).contiguous()
    planes = window_planes(img, epsilon)
    if lowp:
        planes = bf16(planes)
    n_k, mu, ldl, diag = planes[:, 7], planes[:, 8:11], planes[:, 0:6], \
        planes[:, 6]
    is_known = ((tri < 0.1) | (tri > 0.9)).to(torch.float32)
    b = lam * (tri > 0.9).to(torch.float32)
    m_inv = 1.0 / torch.clamp_min(diag + lam * is_known, 1e-6)
    store = bf16 if lowp else (lambda t: t)

    def amv(q):
        return laplacian_matvec(img, n_k, mu, ldl, q) + lam * is_known * q

    x = store(torch.where(is_known > 0, tri, torch.clamp(x0, 0.0, 1.0)))
    r = store(b - amv(x))
    p = store(m_inv * r)
    bnorm = torch.sqrt(_bsum(b * b)) + 1e-30
    rz = _bsum(r * p)
    nb = tri.shape[0]
    pending = torch.zeros(nb, dtype=torch.bool, device=tri.device)
    it = torch.zeros(nb, dtype=torch.int32, device=tri.device)

    def cond(r, it):
        res = torch.sqrt(_bsum(r * r)) / bnorm
        return (res > rtol) & (it < max_iter) & torch.isfinite(res)

    active = cond(r, it)
    while bool(active.any()):
        y = amv(_bw(pending, x, p))
        r_r = b - y
        pap = _bsum(p * y)
        broke = ~(pap > 1e-10 * _bsum(p * p))
        step = (rz / torch.where(broke, 1.0, pap))[:, None, None]
        x_a = x + step * p
        r_a = r - step * y
        adv = (~pending) & (~broke)
        x2 = _bw(adv, x_a, x)
        r2 = _bw(pending, r_r, _bw(adv, r_a, r))
        z = m_inv * r2
        rz2 = _bsum(r2 * z)
        beta = torch.where(adv, rz2 / torch.clamp_min(rz, 1e-30), 0.0)
        moved = pending | adv
        p2 = _bw(moved, z + beta[:, None, None] * p, p)
        rz3 = torch.where(moved, rz2, rz)
        pending2 = broke & ~pending
        x = store(_bw(active, x2, x))
        r = store(_bw(active, r2, r))
        p = store(_bw(active, p2, p))
        rz = torch.where(active, rz3, rz)
        pending = torch.where(active, pending2, pending)
        it = it + active.to(torch.int32)
        active = cond(r, it)
    return torch.clamp(x, 0.0, 1.0), it


# ---------------------------------------------------------------------------
# deterministic weighted k-means and the palette map
# ---------------------------------------------------------------------------

_KBLOCK = 1 << 17


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _pairwise_d2(x, c):
    xc = _dot3(x[:, :, None, :], c[:, None, :, :])
    x2 = _dot3(x, x)[..., None]
    c2 = _dot3(c, c)[:, None, :]
    return torch.clamp_min(x2 - 2.0 * xc + c2, 0.0)


def _gather_rows(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _min_d2_blocked(pts, w, centers):
    return torch.stack(
        [_pairwise_d2(pts[:, i], centers).amin(dim=2) * (w[:, i] > 0)
         for i in range(pts.shape[1])], dim=1)


def _assign_stats(pts, w, centers):
    bsz, nb, _, d = pts.shape
    k = centers.shape[1]
    sums = torch.zeros((bsz, k, d), dtype=torch.float32, device=pts.device)
    counts = torch.zeros((bsz, k), dtype=torch.float32, device=pts.device)
    for i in range(nb):
        pb, wb = pts[:, i], w[:, i]
        lbl = torch.argmin(_pairwise_d2(pb, centers), dim=2)
        onehot = F.one_hot(lbl, k).to(torch.float32) * wb[..., None]
        sums = sums + (onehot[..., None] * pb[:, :, None, :]).sum(dim=1)
        counts = counts + onehot.sum(dim=1)
    return sums, counts


def _reseed_empty(pts, w, centers, counts):
    bsz, nb, blk, d = pts.shape
    k = centers.shape[1]
    md = _min_d2_blocked(pts, w, centers).reshape(bsz, -1)
    far = torch.sort(md, dim=-1, descending=True, stable=True).indices[:, :k]
    far_pts = _gather_rows(pts.reshape(bsz, nb * blk, d), far)
    empty = counts == 0
    slot = torch.clamp(torch.cumsum(empty.to(torch.int32), dim=1) - 1,
                       0, k - 1)
    return torch.where(empty[..., None],
                       _gather_rows(far_pts, slot.to(torch.int64)), centers)


def kmeans_fit_det(points, weights, k: int, lowp: bool, max_iter: int = 300,
                   candidates: int = 8) -> torch.Tensor:
    """Greedy-potential seeding at stratified quantiles of the potential
    CDF, then weighted Lloyd to sklearn's tolerance, per image:
    (B, N, 3), (B, N) -> centres (B, k, 3) float32, snapped to integers
    within 1e-3."""
    points = points.to(torch.float32)
    weights = weights.to(torch.float32)
    bsz, n, d = points.shape
    block = min(_KBLOCK, max(1024, -(-n // 1024) * 1024))
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        points = F.pad(points, (0, 0, 0, pad))
        weights = F.pad(weights, (0, pad))
    pts = points.reshape(bsz, nb, block, d)
    w = weights.reshape(bsz, nb, block)
    flatp = pts.reshape(bsz, nb * block, d)
    flatw = w.reshape(bsz, nb * block)
    dev = points.device

    c0 = _gather_rows(flatp, torch.argmax(flatw, dim=1)[:, None])
    centers = torch.zeros((bsz, k, d), dtype=torch.float32, device=dev)
    centers[:, 0:1] = c0
    min_d2 = _min_d2_blocked(pts, w, c0).reshape(bsz, -1)
    frac = true_div(torch.arange(candidates, dtype=torch.float32,
                                 device=dev) + 0.5, candidates)
    for i in range(1, k):
        cdf = cumsum(flatw * min_d2).contiguous()
        cand_idx = torch.clamp(torch.searchsorted(cdf, frac[None, :]
                                                  * cdf[:, -1:]),
                               0, flatp.shape[1] - 1)
        cands = _gather_rows(flatp, cand_idx)
        pots = torch.zeros((bsz, candidates), dtype=torch.float32,
                           device=dev)
        nds = []
        for j in range(nb):
            pb, wb = pts[:, j], w[:, j]
            md = min_d2.reshape(bsz, nb, block)[:, j]
            nd = torch.minimum(_pairwise_d2(pb, cands), md[..., None]) \
                * (wb > 0)[..., None]
            pots = pots + tree_sum((nd * wb[..., None]).transpose(1, 2))
            nds.append(nd)
        nd = torch.cat(nds, dim=1)
        best = torch.argmin(pots, dim=1)
        centers[:, i] = cands[torch.arange(bsz, device=dev), best]
        min_d2 = torch.gather(nd, 2, best[:, None, None].expand(
            -1, nd.shape[1], 1))[..., 0]

    # sklearn's tolerance: 1e-4 x the mean per-dimension variance x k
    wsum = torch.clamp_min(tree_sum(flatw), 1.0)
    mean = tree_sum((flatp * flatw[..., None]).transpose(1, 2)) / wsum[:, None]
    dev2 = flatp - mean[:, None]
    var = tree_sum((dev2 * dev2 * flatw[..., None]).transpose(1, 2)) \
        / wsum[:, None]
    tol = 1e-4 * true_div((var[:, 0] + var[:, 1]) + var[:, 2], d) * k

    shift2 = torch.full((bsz,), float("inf"), device=dev)
    it = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    active = (shift2 > tol) & (it < max_iter)
    while bool(active.any()):
        sums, counts = _assign_stats(pts, w, centers)
        new = torch.where(counts[..., None] > 0,
                          sums / torch.clamp_min(counts, 1.0)[..., None],
                          centers)
        new = _reseed_empty(pts, w, new, counts)
        if lowp:
            new = bf16(new)
        shift = new - centers
        s2 = tree_sum((shift * shift).reshape(bsz, -1))
        centers = torch.where(active[:, None, None], new, centers)
        shift2 = torch.where(active, s2, shift2)
        it = it + active.to(torch.int32)
        active = (shift2 > tol) & (it < max_iter)
    rounded = torch.round(centers)
    return torch.where(torch.abs(centers - rounded) < 1e-3, rounded, centers)


def _span_idx(n: int, count: int, device) -> torch.Tensor:
    return (torch.arange(count, device=device) * n) // count \
        + max(n // (2 * count), 0)


def _pick_index_set(cnt, uni, ok, count):
    mass = torch.sort(cnt, dim=1, descending=True, stable=True) \
        .indices[:, :count]
    mass = torch.sort(mass, dim=1).values
    return torch.where(ok[:, None], uni[None, :], mass)


def grid_sample_colors(rgb, fit2d, min_mass: int, cap: int = 1 << 14):
    """Systematic grid sample of the fit-masked colours per image: about
    128 rows, then columns of those rows, the heaviest rows or columns
    where the uniform grid catches less than min_mass."""
    bsz, h, w = fit2d.shape
    dev = rgb.device
    R = min(h, 128)
    ncol = min(w, max(1, cap // R))
    ar = torch.arange(bsz, device=dev)
    row_cnt = fit2d.sum(dim=2, dtype=torch.int32)
    uni_rows = _span_idx(h, R, dev)
    col_scale = float(np.float32(ncol) / np.float32(w))
    rows_ok = row_cnt[:, uni_rows].sum(dim=1).to(torch.float32) \
        * col_scale >= float(min_mass)
    row_idx = _pick_index_set(row_cnt, uni_rows, rows_ok, R)
    rows = rgb[ar[:, None], row_idx]
    rfit = fit2d[ar[:, None], row_idx]
    col_cnt = rfit.sum(dim=1, dtype=torch.int32)
    uni_cols = _span_idx(w, ncol, dev)
    cols_ok = col_cnt[:, uni_cols].sum(dim=1).to(torch.float32) \
        >= float(min_mass)
    col_idx = _pick_index_set(col_cnt, uni_cols, cols_ok, ncol)
    sample = torch.gather(rows, 2, col_idx[:, None, :, None].expand(
        -1, R, -1, 3)).reshape(bsz, -1, 3).to(torch.float32)
    wts = torch.gather(rfit, 2, col_idx[:, None, :].expand(-1, R, -1)) \
        .reshape(bsz, -1).to(torch.float32)
    if sample.shape[1] < cap:
        pad = cap - sample.shape[1]
        sample = F.pad(sample, (0, 0, 0, pad))
        wts = F.pad(wts, (0, pad))
    return sample[:, :cap], wts[:, :cap]


_THIRD = float(np.float32(1.0 / 3.0))


def quantize(rgb: torch.Tensor, sharp: torch.Tensor, k: int, lowp: bool):
    """The quantize stage: black-filter ladder (30 -> 10 -> none), grid
    sample, k-means, nearest-palette map of the opaque, bright-enough
    pixels -> (rgb u8 (B, H, W, 3), palettes u8 (B, k, 3))."""
    bsz, h, w = sharp.shape
    flat = rgb.reshape(bsz, -1, 3).to(torch.float32)
    nt = sharp.reshape(bsz, -1)
    brightness = true_div((flat[..., 0] + flat[..., 1]) + flat[..., 2], 3.0)
    n30 = (nt & (brightness > 30)).sum(dim=1)
    n10 = (nt & (brightness > 10)).sum(dim=1)
    thr = torch.where(n30 >= k, 30.0, torch.where(n10 > 0, 10.0, -1.0))
    fit = nt & (brightness > thr[:, None])
    sample, wts = grid_sample_colors(rgb, fit.reshape(bsz, h, w),
                                     min_mass=max(k, 64))
    centers = kmeans_fit_det(sample, wts, k, lowp)
    pal = torch.clamp(centers, 0, 255).to(torch.uint8)
    # the palette map, first minimum among the entries (strict <)
    c_f = pal.to(torch.float32)
    f = rgb.to(torch.float32)
    r, g, bl = f[..., 0], f[..., 1], f[..., 2]
    best_d = torch.full_like(r, float("inf"))
    best = torch.zeros_like(f)
    for j in range(k):
        c = c_f[:, j]
        cr, cg, cb = (c[:, i, None, None] for i in range(3))
        dr, dg, db = r - cr, g - cg, bl - cb
        d = (dr * dr + dg * dg) + db * db
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best = torch.where(better[..., None], c[:, None, None, :], best)
    bright = ((r + g) + bl) * _THIRD
    keep = sharp & (bright > thr[:, None, None])
    out = torch.where(keep[..., None], best, 0.0)
    return out.to(torch.int32).to(torch.uint8), pal
