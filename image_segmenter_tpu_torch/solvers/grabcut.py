"""GrabCut: GMM-EM colour models and a grid min-cut, in PyTorch.

Counterpart of image_segmenter_tpu/solvers/grabcut.py (the reference's
cv2.grabCut, grabcut.py:52-54). The same energy model as OpenCV: two
5-component full-covariance GMMs, n-link weight gamma/dist *
exp(-beta ||ci - cj||^2) over the 8-neighbourhood with beta = 1 / (2
E||ci - cj||^2) and gamma = 50, data terms -log sum_k w_k N(x; mu_k,
Sigma_k). The min-cut is the JAX package's: the exact convex relaxation
min_{u in [0, 1]} sum a_p u_p + sum w_pq |u_p - u_q|, minimised by a
diagonally preconditioned Chambolle-Pock loop of shift stencils and
thresholded at 0.5, with known pixels clamped.

Lanes. Every function takes a leading lane axis C: C = 1 for the plain
alternation, C = 2K = 10 for the split-merge polish's candidates. The JAX
package vmaps one alternation over its candidates; under vmap each lane's
`while_loop` freezes when its own condition goes false. `tv_mincut` keeps
that per lane: its body updates a lane only while the lane is active, and
the host reads whether any lane is active once per chunk of `_CHUNK`
iterations. A frozen lane's state does not change, so the chunked loop
gives the bits of a loop that checks every iteration.

Sums. The GMM moments are sums of integer-valued products (u8 pixels,
0/1 weights): they run in float64, where they are exact in any order, and
are rounded to float32 once, so the card and the CPU give the same
moments. Other sums over pixels (beta, the standardized energy, the split
variance) run in float64 and are rounded once; the energy sums each lane
in a tensor of its own, so a lane's score has the same bits whatever the
lane count. The 3 x 3 inverses and
determinants are the closed-form adjugate in float64: `torch.linalg.inv`
checks its result on the host, a device-to-host sync on every call on
CUDA, and the closed form needs no factorisation of a 3 x 3 matrix.

Host reads. The alternations enqueue back to back (the JAX package's
async dispatch): one read per chunk of the cut. The polish keeps its
accept and carry decisions on the device (`torch.where`) and reads the
host at most twice, as the JAX package does. The k-means fits that seed
each GMM (solvers/kmeans.kmeans_fit) read one flag per Lloyd iteration,
and the polish's evaluator fits one per candidate, one candidate after
another.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils.backend import resolve_device

GAMMA = 50.0
K_COMP = DEFAULTS.grabcut_gmm_components

# Diagnostics of the most recent grabcut_core call, under the JAX
# package's keys (stage stamps in seconds, host clock, each fenced by a
# synchronise where the JAX package blocks)
LAST_SOLVE_INFO: dict = {}

# mask values (cv2 semantics)
BGD, FGD, PR_BGD, PR_FGD = 0, 1, 2, 3

# 1 / sqrt(2) as the JAX package has it: the float32 square root read
# back as a Python float, then inverted in double precision
_INV_SQRT2 = 1.0 / float(np.sqrt(np.float32(2.0)))
_DIRS = [  # (dy, dx, inv_dist): right/down/down-right/down-left cover all
    (0, 1, 1.0),
    (1, 0, 1.0),
    (1, 1, _INV_SQRT2),
    (1, -1, _INV_SQRT2),
]

# 3 log(2 pi) in float32, as jnp evaluates it
_LOG_2PI_3 = float(np.float32(3.0) * np.log(np.float32(2.0 * np.pi)))

_CHUNK = 50  # Chambolle-Pock iterations between two host reads


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x[..., y + dy, x + dx] over the last two axes, 0 outside."""
    h, w = x.shape[-2:]
    p = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    y0, x0 = max(dy, 0), max(dx, 0)
    return p[..., y0:y0 + h, x0:x0 + w]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# --------------------------------------------------------------------------
# GMM
# --------------------------------------------------------------------------

class GMM(NamedTuple):
    weights: torch.Tensor  # (C, K)
    means: torch.Tensor    # (C, K, 3)
    covs: torch.Tensor     # (C, K, 3, 3)
    icovs: torch.Tensor    # (C, K, 3, 3)
    logdets: torch.Tensor  # (C, K)


def _gmm_map(fn, *gmms: GMM) -> GMM:
    return GMM(*(fn(*leaves) for leaves in zip(*gmms)))


def _det_adj(covs: torch.Tensor):
    """Determinant and adjugate of (..., 3, 3) matrices, in float64."""
    c = covs.to(torch.float64)
    a, b, e3 = c[..., 0, 0], c[..., 0, 1], c[..., 0, 2]
    d, e, f = c[..., 1, 0], c[..., 1, 1], c[..., 1, 2]
    g, h, i = c[..., 2, 0], c[..., 2, 1], c[..., 2, 2]
    c00, c01, c02 = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * c00 + b * c01 + e3 * c02
    adj = torch.stack([
        c00, e3 * h - b * i, b * f - e3 * e,
        c01, a * i - e3 * g, e3 * d - a * f,
        c02, b * g - a * h, a * e - b * d,
    ], dim=-1).reshape(*c.shape)
    return det, adj


def _regularize(covs: torch.Tensor) -> torch.Tensor:
    """OpenCV adds 0.01 to the diagonal when the determinant underflows."""
    det = _det_adj(covs)[0].to(torch.float32)
    eye = torch.eye(3, dtype=torch.float32, device=covs.device) * 0.01
    return torch.where((det < 1e-6)[..., None, None], covs + eye, covs)


def _gmm_from_moments(sums, outer, counts) -> GMM:
    """sums (C, K, 3), outer (C, K, 3, 3), counts (C, K) -> GMM."""
    total = torch.clamp_min(counts.sum(dim=-1, keepdim=True), 1.0)
    w = counts / total
    safe = torch.clamp_min(counts, 1.0)[..., None]
    means = sums / safe
    covs = outer / safe[..., None] - means[..., :, None] * means[..., None, :]
    covs = _regularize(covs)
    det, adj = _det_adj(covs)
    icovs = (adj / det[..., None, None]).to(torch.float32)
    logdets = torch.log(torch.clamp_min(det.to(torch.float32), 1e-30))
    return GMM(w, means, covs, icovs, logdets)


def _component_moments(pixels, weights_px, comp, k):
    """Per-component weighted moments: pixels (N, 3), weights_px (C, N),
    comp (C, N) -> sums (C, k, 3), outer (C, k, 3, 3), counts (C, k),
    float32. Summed in float64: u8 pixels and 0/1 weights make every
    partial sum an integer, exact in any order."""
    c, n = weights_px.shape
    oh = F.one_hot(comp, k).to(torch.float64) \
        * weights_px.to(torch.float64)[..., None]               # (C, N, k)
    p = pixels.to(torch.float64)
    pp = torch.cat([p, (p[:, :, None] * p[:, None, :]).reshape(n, 9)], dim=1)
    m = torch.matmul(oh.transpose(1, 2), pp)                     # (C, k, 12)
    return (m[..., :3].to(torch.float32),
            m[..., 3:].reshape(c, k, 3, 3).to(torch.float32),
            oh.sum(dim=1).to(torch.float32))


def _loglik(pixels: torch.Tensor, gmm: GMM) -> torch.Tensor:
    """(C, N, K) log of w_k N(x; mu_k, Sigma_k)."""
    d = pixels[None, :, None, :] - gmm.means[:, None]           # (C, N, K, 3)
    ic = gmm.icovs[:, None]                                      # (C, 1, K, 3, 3)
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    t = [(d0 * ic[..., 0, j] + d1 * ic[..., 1, j]) + d2 * ic[..., 2, j]
         for j in range(3)]
    maha = (t[0] * d0 + t[1] * d1) + t[2] * d2
    log_norm = -0.5 * (maha + gmm.logdets[:, None] + _LOG_2PI_3)
    return log_norm + torch.log(torch.clamp_min(gmm.weights, 1e-12))[:, None]


def _data_term(pixels: torch.Tensor, gmm: GMM) -> torch.Tensor:
    """-log p(x) under the mixture: (C, N). The sum over components runs
    in component order, whatever the lane count."""
    ll = _loglik(pixels, gmm)
    m = ll.amax(dim=-1)
    s = torch.exp(ll[..., 0] - m)
    for j in range(1, ll.shape[-1]):
        s = s + torch.exp(ll[..., j] - m)
    return -(m + torch.log(s))


def _assign(pixels: torch.Tensor, gmm: GMM) -> torch.Tensor:
    """Most likely component per pixel (the first on ties): (C, N)."""
    return torch.argmax(_loglik(pixels, gmm), dim=-1)


def _init_gmm(pixels: torch.Tensor, weights_px: torch.Tensor,
              seed: int) -> GMM:
    """kmeans-seeded GMM per lane: weights_px (C, N). The lanes' k-means
    fits run one after another."""
    comps = []
    for wl in weights_px:
        res = KM.kmeans_fit(pixels, wl, K_COMP, n_init=3, max_iter=30,
                            seed=seed)
        comps.append(KM.assign_labels(pixels[None], res.centers[None])[0])
    comp = torch.stack(comps)
    return _gmm_from_moments(*_component_moments(pixels, weights_px, comp,
                                                 K_COMP))


# --------------------------------------------------------------------------
# n-link weights (OpenCV calcBeta / calcNWeights)
# --------------------------------------------------------------------------

def _nlink_weights(img: torch.Tensor) -> torch.Tensor:
    """Edge weights (4, H, W) of the 4 canonical directions from a
    (3, H, W) float32 image.

    beta = 1 / (2 mean ||ci - cj||^2) over all 8-neighbourhood pairs
    (cv::grabcut calcBeta); weight = gamma * inv_dist * exp(-beta * d2).
    Edge (p, p + dir) is stored at p; out-of-bounds edges are 0.
    """
    h, w = img.shape[-2:]
    dev = img.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    d2s, valids = [], []
    total_n = 0
    for dy, dx, _ in _DIRS:
        diff = img - _shift(img, dy, dx)
        d2 = (diff[0] * diff[0] + diff[1] * diff[1]) + diff[2] * diff[2]
        valid = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
        d2s.append(torch.where(valid, d2, 0.0))
        valids.append(valid)
        total_n += max(h - abs(dy), 0) * max(w - abs(dx), 0)
    total_d2 = torch.stack(d2s).to(torch.float64).sum().to(torch.float32)
    n = torch.full((), float(total_n), dtype=torch.float32, device=dev)
    beta = torch.where(total_d2 > 1e-12, n / (2.0 * total_d2),
                       torch.zeros((), device=dev))
    weights = [torch.where(valid, (GAMMA * inv_dist) * torch.exp(-beta * d2),
                           0.0)
               for (_, _, inv_dist), d2, valid in zip(_DIRS, d2s, valids)]
    return torch.stack(weights)


# --------------------------------------------------------------------------
# min-cut via Chambolle-Pock anisotropic weighted TV
# --------------------------------------------------------------------------

def tv_mincut(unary: torch.Tensor, edge_weights: torch.Tensor,
              fixed_fg: torch.Tensor, fixed_bg: torch.Tensor,
              max_iter: int = 2000, warm_y: Optional[torch.Tensor] = None,
              chunk: int = _CHUNK):
    """min_{u in [0,1]} sum a_p u_p + sum w_pq |u_p - u_q| per lane, u
    clamped on fixed pixels. a_p = D_fg(p) - D_bg(p) (positive pushes to
    BG = 0).

    unary (C, H, W); edge_weights (4, H, W), shared by the lanes;
    fixed_fg, fixed_bg (C, H, W) bool; warm_y (C, 4, H, W), the previous
    alternation's dual state, or None. Returns (u (C, H, W), iterations
    (C,) int32, y (C, 4, H, W)); threshold u at 0.5 for the cut.

    A lane runs while it < max_iter and (its last max |u_new - u| >
    2e-5 or it < 50). The host reads whether any lane still runs once per
    `chunk` iterations; a stopped lane is frozen, so every chunk length
    gives the same bits.
    """
    c, h, w = unary.shape
    dev = unary.device
    wts = edge_weights
    # Diagonal preconditioning (Pock & Chambolle 2011) for the unweighted
    # difference operator: each edge row sums to 2 -> sigma = 1/2; each
    # pixel column sums to its incident edge count -> tau_p = 1/deg_p.
    deg = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for i, (dy, dx, _) in enumerate(_DIRS):
        has_e = (wts[i] > 0).to(torch.float32)
        deg = deg + has_e + _shift(has_e, -dy, -dx)
    tau = torch.reciprocal(torch.clamp_min(deg, 1.0))
    sigma = 0.5
    # clamp(u) = where(fg, 1, where(bg, 0, clip(u, 0, 1)))
    lo = fixed_fg.to(torch.float32)
    hi = (~fixed_bg).to(torch.float32)
    neg_wts = -wts

    u = torch.clamp((unary <= 0).to(torch.float32), lo, hi)
    ubar = u
    if warm_y is None:
        y = torch.zeros((c, 4, h, w), dtype=torch.float32, device=dev)
    else:
        # project the carried dual into the new weights' feasible box
        y = torch.clamp(warm_y, neg_wts, wts)
    it = torch.zeros((c,), dtype=torch.int32, device=dev)
    delta = torch.full((c,), float("inf"), device=dev)

    def running(it, delta):
        return (it < max_iter) & ((delta > 2e-5) | (it < 50))

    def body(u, ubar, y, it, delta):
        active = running(it, delta)
        # dual ascent: y_e <- proj_{|y| <= w}(y + sigma (ubar_p - ubar_q))
        pu = F.pad(ubar, (1, 1, 1, 1))
        nb = torch.stack([pu[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy, dx, _ in _DIRS], dim=1)
        y_new = torch.clamp(y + sigma * (ubar[:, None] - nb), neg_wts, wts)
        py = F.pad(y_new, (1, 1, 1, 1))
        div = None
        for i, (dy, dx, _) in enumerate(_DIRS):
            back = py[:, i, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
            div = y_new[:, i] - back if div is None \
                else div + y_new[:, i] - back
        u_new = torch.clamp(u - tau * (unary + div), lo, hi)
        ubar_new = 2.0 * u_new - u
        d_new = torch.abs(u_new - u).amax(dim=(1, 2))
        a3 = active[:, None, None]
        return (torch.where(a3, u_new, u), torch.where(a3, ubar_new, ubar),
                torch.where(a3[:, None], y_new, y),
                it + active.to(torch.int32), torch.where(active, d_new, delta))

    done = 0
    while done < max_iter:
        n = min(chunk, max_iter - done)
        for _ in range(n):
            u, ubar, y, it, delta = body(u, ubar, y, it, delta)
        done += n
        if not bool(running(it, delta).any()):  # one host read a chunk
            break
    return u, it, y


# --------------------------------------------------------------------------
# full GrabCut loop
# --------------------------------------------------------------------------

class Image(NamedTuple):
    """What every alternation of one image reads: lane-invariant."""
    img: torch.Tensor      # (H, W, 3) uint8 BGR
    pixels: torch.Tensor   # (H * W, 3) float32
    edge_w: torch.Tensor   # (4, H, W) n-link weights


def prepare(img_bgr: torch.Tensor) -> Image:
    """An (H, W, 3) uint8 tensor -> its pixels and n-link weights."""
    img = img_bgr.to(torch.float32)
    return Image(img_bgr, img.reshape(-1, 3),
                 _nlink_weights(img.permute(2, 0, 1)))


def _fg_of(m: torch.Tensor) -> torch.Tensor:
    return ((m == FGD) | (m == PR_FGD)).to(torch.float32)


def _grabcut_init(im: Image, init_mask: torch.Tensor, seed: int = 42):
    """GMMs seeded from the init mask (H, W): one lane each."""
    fg_w0 = _fg_of(init_mask).reshape(1, -1)
    return (_init_gmm(im.pixels, fg_w0, seed),
            _init_gmm(im.pixels, 1.0 - fg_w0, seed + 1))


def _grabcut_iter(im: Image, masks: torch.Tensor, fg_gmm: GMM, bg_gmm: GMM,
                  cut_y: Optional[torch.Tensor] = None, cut_iters: int = 2500):
    """One assign/learn/cut alternation for every lane: masks (C, H, W)
    uint8, GMMs of C lanes, cut_y (C, 4, H, W) or None.

    cut_y carries the TV dual state between alternations so each cut
    resumes where the last converged (the GMMs, hence the unary, move
    slowly after the first pass). Returns (masks, fg_gmm, bg_gmm, y, it)."""
    c, h, w = masks.shape
    pixels = im.pixels
    fg_w = _fg_of(masks).reshape(c, -1)
    bg_w = 1.0 - fg_w
    fg_comp = _assign(pixels, fg_gmm)
    bg_comp = _assign(pixels, bg_gmm)
    fg_gmm = _gmm_from_moments(*_component_moments(pixels, fg_w, fg_comp,
                                                   K_COMP))
    bg_gmm = _gmm_from_moments(*_component_moments(pixels, bg_w, bg_comp,
                                                   K_COMP))
    # unary = D_fg - D_bg: u = 1 means FG, so FG assignment pays D_fg
    unary = (_data_term(pixels, fg_gmm)
             - _data_term(pixels, bg_gmm)).reshape(c, h, w)
    u, it, y = tv_mincut(unary, im.edge_w, masks == FGD, masks == BGD,
                         max_iter=cut_iters, warm_y=cut_y)
    unknown = (masks == PR_BGD) | (masks == PR_FGD)
    cut = torch.where(u > 0.5, PR_FGD, PR_BGD).to(torch.uint8)
    return torch.where(unknown, cut, masks), fg_gmm, bg_gmm, y, it


# --------------------------------------------------------------------------
# standardized mask energy + split-merge polish
# --------------------------------------------------------------------------

def _side_nll(pixels: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    gmm0 = _init_gmm(pixels, wts, 42)
    comp = _assign(pixels, gmm0)
    gmm = _gmm_from_moments(*_component_moments(pixels, wts, comp, K_COMP))
    return _data_term(pixels, gmm)


def mask_energy(im: Image, fg01: torch.Tensor) -> torch.Tensor:
    """GrabCut energy of hard segmentations fg01 (C, H, W) under GMMs fit
    to each one's own partition by a fixed protocol (kmeans-seeded EM
    refit, seed 42): (C,) float32. The common evaluator the polish and the
    collapse restart judge with. Scoring candidates with the algorithm's
    own GMM likelihoods instead is invalid: overfit tiny-covariance
    components make a worse mask look better.

    A lane's score has the same bits at any lane count: its k-means fits
    run alone (`_init_gmm`), the moments are exact, and each of its five
    float64 sums reduces a tensor of the lane's own, so the reduction's
    order cannot follow the batch's shape."""
    c, h, w = fg01.shape
    fw = fg01.reshape(c, -1).to(torch.float32)
    nll = torch.where(fw > 0, _side_nll(im.pixels, fw),
                      _side_nll(im.pixels, 1.0 - fw))
    u = fw.reshape(c, h, w)
    terms = [nll] + [wd * torch.abs(u - _shift(u, dy, dx))
                     for (dy, dx, _), wd in zip(_DIRS, im.edge_w)]
    totals = []
    for i in range(c):
        total = None
        for t in terms:
            s = t[i].to(torch.float64).sum()
            total = s if total is None else total + s
        totals.append(total)
    return torch.stack(totals).to(torch.float32)


def _split_candidates(im: Image, side_w01: torch.Tensor, gmm: GMM) -> GMM:
    """K candidate GMMs from one (a GMM of one lane; side_w01 (N,)): lane
    s splits component s in two (weighted 2-means seeded on the
    diagonal-covariance axis, 12 Lloyd steps) and merges the closest
    remaining pair.

    EM from a kmeans init is a fixed point that can starve a small,
    tightly coloured pixel population of its own component; a split-merge
    proposal is the standard escape move, accepted by mask_energy."""
    pixels = im.pixels
    n = pixels.shape[0]
    dev = pixels.device
    k = K_COMP
    s_ids = torch.arange(k, device=dev)
    p64 = pixels.to(torch.float64)
    comp = _assign(pixels, gmm)[0]                               # (N,)
    mw = side_w01[None] * (comp[None] == s_ids[:, None]).to(torch.float32)
    mw64 = mw.to(torch.float64)
    msum = torch.clamp_min(mw64.sum(dim=1).to(torch.float32), 1e-6)[:, None]
    mean = torch.matmul(mw64, p64).to(torch.float32) / msum      # (K, 3)
    dev2 = (pixels[None] - mean[:, None]) ** 2                   # (K, N, 3)
    var = torch.matmul(mw64[:, None], dev2.to(torch.float64))[:, 0] \
        .to(torch.float32) / msum
    delta = torch.sqrt(torch.clamp_min(var, 1e-4))
    cs = torch.stack([mean - delta, mean + delta], dim=1)        # (K, 2, 3)

    for _ in range(12):
        diff = pixels[None, :, None, :] - cs[:, None]            # (K, N, 2, 3)
        d2 = (diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2
        a = torch.argmin(d2, dim=2)
        oh = F.one_hot(a, 2).to(torch.float64) * mw64[..., None]  # (K, N, 2)
        cnt = oh.sum(dim=1).to(torch.float32)                    # (K, 2)
        newc = torch.matmul(oh.transpose(1, 2), p64).to(torch.float32) \
            / torch.clamp_min(cnt, 1e-6)[..., None]
        cs = torch.where((cnt > 0)[..., None], newc, cs)

    means = gmm.means[0]                                         # (K, 3)
    cnts = (F.one_hot(comp, k).to(torch.float64)
            * side_w01.to(torch.float64)[:, None]).sum(dim=0).to(torch.float32)
    dm = means[:, None] - means[None]
    d2p = (dm[..., 0] ** 2 + dm[..., 1] ** 2) + dm[..., 2] ** 2  # (K, K)
    ii = s_ids
    valid = ((ii[:, None] < ii[None, :])[None]
             & (ii[None, :, None] != s_ids[:, None, None])
             & (ii[None, None, :] != s_ids[:, None, None]))      # (K_s, K, K)
    idx = torch.argmin(torch.where(valid, d2p[None], float("inf"))
                       .reshape(k, -1), dim=1)
    i, j = idx // k, idx % k
    merged = ((cnts[i, None] * means[i] + cnts[j, None] * means[j])
              / torch.clamp_min(cnts[i] + cnts[j], 1e-6)[:, None])
    new_means = means[None].repeat(k, 1, 1)
    new_means[s_ids, s_ids] = cs[:, 0]
    new_means[s_ids, i] = merged
    new_means[s_ids, j] = cs[:, 1]
    comp_new = KM.assign_labels(pixels[None].expand(k, n, 3), new_means)
    return _gmm_from_moments(*_component_moments(
        pixels, side_w01[None].expand(k, n), comp_new, k))


def _accepts_dev(e_cand: torch.Tensor, e_inc: torch.Tensor) -> torch.Tensor:
    """Whether a candidate's energy strictly improves on the incumbent's,
    as a device bool. The margin keeps the converged mask on ties (and
    scenes where EM already found the optimum bit-stable); the polish keeps
    its accept and carry decisions on the device, so it enqueues without a
    host read per round."""
    return e_cand < e_inc - 1e-6 * torch.abs(e_inc) - 1e-3


def _where_gmm(pred, a: GMM, b: GMM) -> GMM:
    return _gmm_map(lambda x, z: torch.where(pred, x, z), a, b)


def _polish_round(im: Image, mask, fg_gmm: GMM, bg_gmm: GMM, y,
                  extra_iters: int):
    """One split-merge proposal round on one lane (mask (1, H, W), GMMs
    of one lane, y (1, 4, H, W)): build 2K candidate GMM pairs (split each
    FG and each BG component), continue each for `extra_iters` batched
    alternations, and take the one of least standardized energy. Returns
    the winner's (mask, fg_gmm, bg_gmm, y, energy), each of one lane;
    nothing is read on the host.

    The JAX package ranks with its vmapped evaluator and confirms the
    winner with the unbatched one, because the two round differently. The
    port's `mask_energy` gives a lane the same bits at any lane count, so
    the ranking score is the confirmed one."""
    n_cand = 2 * K_COMP
    fg01 = _fg_of(mask).reshape(-1)
    fg_splits = _split_candidates(im, fg01, fg_gmm)
    bg_splits = _split_candidates(im, 1.0 - fg01, bg_gmm)
    fgg = _gmm_map(lambda a, b: torch.cat([a, b.expand(K_COMP, *b.shape[1:])]),
                   fg_splits, fg_gmm)
    bgg = _gmm_map(lambda a, b: torch.cat([a.expand(K_COMP, *a.shape[1:]), b]),
                   bg_gmm, bg_splits)
    masks = mask.expand(n_cand, *mask.shape[1:])
    ys = y.expand(n_cand, *y.shape[1:])
    for _ in range(extra_iters):
        masks, fgg, bgg, ys, _ = _grabcut_iter(im, masks, fgg, bgg, ys)
    es = mask_energy(im, _fg_of(masks))
    es = torch.where(torch.isnan(es), float("inf"), es)
    k = torch.argmin(es).reshape(1)
    pick = lambda t: t.index_select(0, k)  # noqa: E731
    return (pick(masks), _gmm_map(pick, fgg), _gmm_map(pick, bgg), pick(ys),
            pick(es)[0])


def _splitmerge_polish(im: Image, mask, fg_gmm: GMM, bg_gmm: GMM, y,
                       extra_iters: int = 3, rounds: int = 3,
                       search_max_dim: Optional[int] = None):
    """Iterated split-merge proposals after EM converges, on one lane
    (mask (1, H, W)). Returns the mask (1, H, W).

    Accepted rounds carry the winning lane's own GMM and dual state into
    the next round: refitting GMMs from the accepted mask can fall back
    into a far worse EM basin.

    Above `search_max_dim` (default config.Defaults
    .grabcut_polish_search_dim) the candidate search runs on an
    AREA-downscaled image: the split-merge candidates live in colour
    space, so the coarse image finds the same escapes at a fraction of
    the cost; only the winning GMM pair is then continued for
    `extra_iters` alternations at full resolution and accepted iff the
    full-resolution mask_energy strictly improves.

    Host reads: at most two, the exact round-1-reject exit (a rejected
    round leaves the carried state unchanged, so later rounds would
    re-propose and re-reject the same candidates) and the any-round-
    accepted gate before the full-resolution continuation. Every accept
    and carry decision is a device-side select."""
    if search_max_dim is None:
        search_max_dim = DEFAULTS.grabcut_polish_search_dim
    h, w = mask.shape[1:]

    if max(h, w) <= int(search_max_dim):
        e_inc = mask_energy(im, _fg_of(mask))[0]
        for r in range(int(rounds)):
            m_c, fg_c, bg_c, y_c, e_c = _polish_round(
                im, mask, fg_gmm, bg_gmm, y, extra_iters)
            acc = _accepts_dev(e_c, e_inc)
            mask = torch.where(acc, m_c, mask)
            fg_gmm = _where_gmm(acc, fg_c, fg_gmm)
            bg_gmm = _where_gmm(acc, bg_c, bg_gmm)
            y = torch.where(acc, y_c, y)
            e_inc = torch.where(acc, e_c, e_inc)
            if r == 0 and not bool(acc):  # host read 1: exact early exit
                return mask
        return mask

    # coarse search, full-resolution acceptance
    nh, nw = RZ.scale_to_max_dim(h, w, int(search_max_dim))
    im_s = prepare(RZ.resize_u8(im.img[None], (nh, nw), RZ.AREA)[0])
    mask_s = RZ.resize_u8(mask, (nh, nw), RZ.NEAREST_CV)
    # settle the coarse state (one alternation builds the coarse dual y)
    mask_s, fg_s, bg_s, y_s, _ = _grabcut_iter(im_s, mask_s, fg_gmm, bg_gmm,
                                               None)
    e_s = mask_energy(im_s, _fg_of(mask_s))[0]
    any_acc = torch.zeros((), dtype=torch.bool, device=mask.device)
    for r in range(int(rounds)):
        m_c, fg_c, bg_c, y_c, e_c = _polish_round(
            im_s, mask_s, fg_s, bg_s, y_s, extra_iters)
        acc = _accepts_dev(e_c, e_s)
        mask_s = torch.where(acc, m_c, mask_s)
        fg_s = _where_gmm(acc, fg_c, fg_s)
        bg_s = _where_gmm(acc, bg_c, bg_s)
        y_s = torch.where(acc, y_c, y_s)
        e_s = torch.where(acc, e_c, e_s)
        any_acc = any_acc | acc
        if r == 0 and not bool(acc):  # host read 1: exact early exit
            return mask

    # host read 2: skip the full-resolution continuation (and its two
    # full-resolution evaluator refits) when no coarse round improved
    if not bool(any_acc):
        return mask

    m_f, fg_f, bg_f, y_f = mask, fg_s, bg_s, y
    for _ in range(int(extra_iters)):
        m_f, fg_f, bg_f, y_f, _ = _grabcut_iter(im, m_f, fg_f, bg_f, y_f)
    e = mask_energy(im, torch.cat([_fg_of(mask), _fg_of(m_f)]))
    return torch.where(_accepts_dev(e[1], e[0]), m_f, mask)


def _anchor_core(init_mask_np) -> Optional[np.ndarray]:
    """Central core of the init-FG bounding box, restricted to unknown
    pixels: the region the collapse restart temporarily clamps to hard FG.
    Pure init-mask geometry (independent of the image, deterministic).
    Returns a bool (H, W) array or None when no usable anchor exists."""
    m = np.asarray(init_mask_np)
    fg_init = (m == FGD) | (m == PR_FGD)
    unknown = (m == PR_BGD) | (m == PR_FGD)
    ys, xs = np.nonzero(fg_init)
    if ys.size == 0:
        return None
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    dy, dx = (y1 - y0) // 4, (x1 - x0) // 4
    anchor = np.zeros(m.shape, bool)
    anchor[y0 + dy:y1 - dy, x0 + dx:x1 - dx] = True
    anchor &= unknown & fg_init
    return anchor if anchor.any() else None


def _run_alternations(im: Image, mask, fg_gmm: GMM, bg_gmm: GMM, y,
                      iterations: int):
    """`iterations` assign/learn/cut alternations, enqueued back to back
    (no host read between them beyond the cuts' own). Returns the final
    state and the alternations' cut iteration counts (device tensors)."""
    cut_iters = []
    for _ in range(int(iterations)):
        mask, fg_gmm, bg_gmm, y, it = _grabcut_iter(im, mask, fg_gmm, bg_gmm,
                                                    y)
        cut_iters.append(it)
    return mask, fg_gmm, bg_gmm, y, cut_iters


def _on(a, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a uint8 tensor on `dev`."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(dev, torch.uint8)


def grabcut_core(img_bgr, init_mask, iterations: Optional[int] = None,
                 seed: int = 42, splitmerge: Optional[bool] = None,
                 device="cuda"):
    """Run GrabCut. img_bgr (H, W, 3) uint8; init_mask (H, W) uint8 in
    {0, 1, 2, 3}; numpy arrays or tensors, moved to `device`.

    Returns the refined mask, a uint8 (H, W) tensor on `device`: unknown
    pixels become PR_FGD/PR_BGD by the cut, known pixels pass through.

    iterations: EM alternations (default config.Defaults.grabcut_iterations).

    splitmerge (default config.Defaults.grabcut_splitmerge): after the EM
    alternations converge, propose split-merge moves on both GMMs and keep
    the best mask under the standardized energy, an escape from the EM
    local optima that cv.grabCut (reference grabcut.py:52-54) has none of.
    """
    dev = resolve_device(device)
    if iterations is None:
        iterations = DEFAULTS.grabcut_iterations
    if splitmerge is None:
        splitmerge = DEFAULTS.grabcut_splitmerge
    init_np = np.asarray(init_mask.cpu() if torch.is_tensor(init_mask)
                         else init_mask)
    LAST_SOLVE_INFO.clear()
    LAST_SOLVE_INFO["h2d_bytes"] = int(np.prod(img_bgr.shape)) \
        + int(init_np.size)
    t0 = time.perf_counter()
    im = prepare(_on(img_bgr, dev))
    mask0 = _on(init_mask, dev)[None]
    fg_gmm0, bg_gmm0 = _grabcut_init(im, mask0[0], seed=seed)
    _sync(dev)
    LAST_SOLVE_INFO["t_init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mask, fg_gmm, bg_gmm, y, cut_its = _run_alternations(
        im, mask0, fg_gmm0, bg_gmm0, None, iterations)
    mask_np = mask[0].cpu().numpy()  # one D2H read fences the EM chain
    LAST_SOLVE_INFO.update(
        t_em=time.perf_counter() - t0,
        em_iters=int(iterations),
        cut_iters=torch.cat(cut_its).tolist() if cut_its else [])

    # Collapse restart (config.Defaults.grabcut_collapse_restart): when the
    # cut leaves (almost) no unknown pixel in the foreground, all-BG was an
    # absorbing EM state, not a discovered optimum; rerun with a core of
    # the init-FG region clamped to hard FG so the GMMs specialise, release
    # the clamp, and keep the standardized-energy winner.
    if DEFAULTS.grabcut_collapse_restart and int(iterations) > 0:
        unknown = (init_np == PR_BGD) | (init_np == PR_FGD)
        fg_u = ((mask_np == FGD) | (mask_np == PR_FGD)) & unknown
        n_unknown = max(int(unknown.sum()), 1)
        collapsed = fg_u.sum() < max(0.005 * n_unknown, 1)
        anchor = _anchor_core(init_np) if collapsed else None
        if anchor is not None:
            t0 = time.perf_counter()
            m_anchor = init_np.copy()
            m_anchor[anchor] = FGD
            m_r, fg_r, bg_r, y_r, _ = _run_alternations(
                im, torch.from_numpy(m_anchor).to(dev)[None], fg_gmm0,
                bg_gmm0, None, iterations)
            # release the clamp: anchor pixels become probable again and the
            # cut settles under the specialised GMMs (warm duals carried)
            anchor_t = torch.from_numpy(anchor).to(dev)[None]
            m_r = torch.where(anchor_t, PR_FGD, m_r).to(torch.uint8)
            m_r, fg_r, bg_r, y_r, _ = _run_alternations(
                im, m_r, fg_r, bg_r, y_r, 3)
            e = mask_energy(im, torch.cat([_fg_of(mask), _fg_of(m_r)]))
            restarted = bool(_accepts_dev(e[1], e[0]))
            if restarted:
                mask, fg_gmm, bg_gmm, y = m_r, fg_r, bg_r, y_r
            LAST_SOLVE_INFO.update(
                t_restart=time.perf_counter() - t0,
                restart_accepted=bool(restarted))
    if splitmerge and int(iterations) > 0:
        t0 = time.perf_counter()
        mask = _splitmerge_polish(im, mask, fg_gmm, bg_gmm, y)
        _sync(dev)
        LAST_SOLVE_INFO["t_polish"] = time.perf_counter() - t0
    return mask[0]
