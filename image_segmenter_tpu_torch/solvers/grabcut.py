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
`while_loop` freezes when its own condition goes false. `CPLoop` keeps
that per lane: its body updates a lane only while the lane is active, and
a step runs a chunk of `CP_CHUNK` iterations. A frozen lane's state does
not change, so the chunked loop gives the bits of a loop that checks
every iteration.

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

Programs. The JAX package jits `_grabcut_init`, one alternation (plain
and vmapped over candidates), `mask_energy` (plain and vmapped) and the
split candidates. Here each of those units is a program
(pipeline/compiled.py), a generator that yields its loops: the
Chambolle-Pock cut (`CPLoop`) and each k-means restart that seeds the
GMMs, every lane's in lock step (solvers/kmeans.RestartLoop). The
polish's round, from the split
candidates to the accepted winner, is one program. On the card every
unit is compiled once per shapes and static arguments and replayed from
CUDA graphs, the units of one image shape in one memory pool, those of
the last `compiled.PROGRAM_SHAPES` shapes kept (`_UNITS`); on the CPU
the same programs run eagerly.

Host reads. The alternations enqueue back to back (the JAX package's
async dispatch), and one D2H read of the mask fences the EM chain. In a
compiled unit each loop reads its stop flag once a chunk it runs and once
to stop: a cut once per `CP_CHUNK` iterations, a k-means restart once per
`kmeans.RESTART_CHUNK` Lloyd iterations. The collapse test reads the
mask, its restart one accept flag, and the polish keeps its accept and
carry decisions on the device (`torch.where`) and reads the host at most
twice, as the JAX package does. Eagerly (the CPU, and
`_grabcut_core_eager` on the card) the cuts read once a chunk too and the
k-means fits once per Lloyd iteration.
"""

from __future__ import annotations

import contextvars
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.pipeline.compiled import ProgramCache
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils.backend import resolve_device
from image_segmenter_tpu_torch.utils.loops import Loop, drive

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

# Chambolle-Pock iterations a step runs, between two host reads. Swept by
# `bench/profile_grabcut.py --chunks` over 10, 25, 50 and 100 on the card:
# 25 is the least at 1 x 1024 x 768 and at 10 x 256 x 192 (a read costs
# about 35 us, a wasted iteration 0.13-0.17 ms). It divides the cut's cap
# of 2500, so a capped loop ends on a chunk's end
CP_CHUNK = 25


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x[..., y + dy, x + dx] over the last two axes, 0 outside."""
    h, w = x.shape[-2:]
    p = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    y0, x0 = max(dy, 0), max(dx, 0)
    return p[..., y0:y0 + h, x0:x0 + w]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _one_hot(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) float64 0/1 rows of `labels` in [0, k): F.one_hot's values
    with no check of the labels on the host."""
    bins = torch.arange(k, device=labels.device)
    return (labels[..., None] == bins).to(torch.float64)


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
    oh = _one_hot(comp, k) * weights_px.to(torch.float64)[..., None]  # (C, N, k)
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


def _init_gmm(pixels: torch.Tensor, weights_px: torch.Tensor, seed: int):
    """kmeans-seeded GMM per lane, a program: weights_px (C, N). The
    lanes' k-means fits run in lock step, as the JAX package vmaps them
    (`kmeans.kmeans_fit_lanes_program`, which yields a loop a restart),
    each lane with the bits of a fit of its own."""
    c = weights_px.shape[0]
    res = yield from KM.kmeans_fit_lanes_program(pixels, weights_px, K_COMP,
                                                 n_init=3, max_iter=30,
                                                 seed=seed)
    comp = KM.assign_labels(pixels[None].expand(c, -1, -1), res.centers)
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

class CPLoop(Loop):
    """min_{u in [0,1]} sum a_p u_p + sum w_pq |u_p - u_q| per lane, u
    clamped on fixed pixels, as a loop its caller drives (pipeline/
    compiled.py): a diagonally preconditioned Chambolle-Pock iteration.
    a_p = D_fg(p) - D_bg(p) (positive pushes to BG = 0).

    unary (C, H, W); edge_weights (4, H, W), shared by the lanes;
    fixed_fg, fixed_bg (C, H, W) bool; warm_y (C, 4, H, W), the previous
    alternation's dual state, or None. After the loop, `u` (C, H, W) is
    the relaxed cut (threshold it at 0.5), `it` (C,) int32 each lane's
    iterations and `y` (C, 4, H, W) the dual state.

    A lane runs while it < max_iter and (its last max |u_new - u| >
    2e-5 or it < 50). `step` runs `chunk` (default `CP_CHUNK`) iterations
    with u, ubar, y, it and delta written in place and `flag` set to
    whether any lane still runs, with no host read, so a CUDA graph can
    capture it. A stopped lane is frozen, so every chunk length gives the
    same bits."""

    def __init__(self, unary: torch.Tensor, edge_weights: torch.Tensor,
                 fixed_fg: torch.Tensor, fixed_bg: torch.Tensor,
                 max_iter: int = 2000, warm_y: Optional[torch.Tensor] = None,
                 chunk: Optional[int] = None):
        c, h, w = unary.shape
        dev = unary.device
        wts = edge_weights
        self.unary, self.wts, self.max_iter = unary, wts, max_iter
        self.chunk = CP_CHUNK if chunk is None else int(chunk)
        # Diagonal preconditioning (Pock & Chambolle 2011) for the
        # unweighted difference operator: each edge row sums to 2 ->
        # sigma = 1/2; each pixel column sums to its incident edge count
        # -> tau_p = 1/deg_p.
        deg = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for i, (dy, dx, _) in enumerate(_DIRS):
            has_e = (wts[i] > 0).to(torch.float32)
            deg = deg + has_e + _shift(has_e, -dy, -dx)
        self.tau = torch.reciprocal(torch.clamp_min(deg, 1.0))
        # clamp(u) = where(fg, 1, where(bg, 0, clip(u, 0, 1)))
        self.lo = fixed_fg.to(torch.float32)
        self.hi = (~fixed_bg).to(torch.float32)
        self.neg_wts = -wts

        self.u = torch.clamp((unary <= 0).to(torch.float32), self.lo, self.hi)
        self.ubar = self.u.clone()
        if warm_y is None:
            self.y = torch.zeros((c, 4, h, w), dtype=torch.float32,
                                 device=dev)
        else:
            # project the carried dual into the new weights' feasible box
            self.y = torch.clamp(warm_y, self.neg_wts, wts)
        self.it = torch.zeros((c,), dtype=torch.int32, device=dev)
        self.delta = torch.full((c,), float("inf"), device=dev)
        self.flag = self._running(self.it, self.delta).any()

    def _running(self, it, delta):
        return (it < self.max_iter) & ((delta > 2e-5) | (it < 50))

    def _body(self, u, ubar, y, it, delta):
        h, w = u.shape[-2:]
        sigma = 0.5
        active = self._running(it, delta)
        # dual ascent: y_e <- proj_{|y| <= w}(y + sigma (ubar_p - ubar_q))
        pu = F.pad(ubar, (1, 1, 1, 1))
        nb = torch.stack([pu[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                          for dy, dx, _ in _DIRS], dim=1)
        y_new = torch.clamp(y + sigma * (ubar[:, None] - nb), self.neg_wts,
                            self.wts)
        py = F.pad(y_new, (1, 1, 1, 1))
        div = None
        for i, (dy, dx, _) in enumerate(_DIRS):
            back = py[:, i, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
            div = y_new[:, i] - back if div is None \
                else div + y_new[:, i] - back
        u_new = torch.clamp(u - self.tau * (self.unary + div), self.lo,
                            self.hi)
        ubar_new = 2.0 * u_new - u
        d_new = torch.abs(u_new - u).amax(dim=(1, 2))
        a3 = active[:, None, None]
        return (torch.where(a3, u_new, u), torch.where(a3, ubar_new, ubar),
                torch.where(a3[:, None], y_new, y),
                it + active.to(torch.int32), torch.where(active, d_new, delta))

    def step(self) -> None:
        """`chunk` iterations; stopped lanes keep their state. No host
        read."""
        state = (self.u, self.ubar, self.y, self.it, self.delta)
        for _ in range(self.chunk):
            state = self._body(*state)
        for dst, src in zip((self.u, self.ubar, self.y, self.it, self.delta),
                            state):
            dst.copy_(src)
        torch.any(self._running(self.it, self.delta), out=self.flag)


def tv_mincut(unary: torch.Tensor, edge_weights: torch.Tensor,
              fixed_fg: torch.Tensor, fixed_bg: torch.Tensor,
              max_iter: int = 2000, warm_y: Optional[torch.Tensor] = None,
              chunk: Optional[int] = None):
    """The cut of `CPLoop` run eagerly: one host read a chunk. Returns
    (u (C, H, W), iterations (C,) int32, y (C, 4, H, W))."""
    loop = CPLoop(unary, edge_weights, fixed_fg, fixed_bg, max_iter=max_iter,
                  warm_y=warm_y, chunk=chunk)
    loop.run()
    return loop.u, loop.it, loop.y


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


# --------------------------------------------------------------------------
# units: the programs the JAX package jits, compiled on the card
# --------------------------------------------------------------------------

# The units' compiled programs (pipeline/compiled.ProgramCache), in
# groups of an image shape and device: a `grabcut_core` call's units (its
# coarse search's too) join the group of its image, a unit called alone
# the group of its own image.
_UNITS = ProgramCache()
# the group of the running `grabcut_core` call: its image's (H, W)
_SHAPE = contextvars.ContextVar("grabcut_shape", default=None)
# true inside `_grabcut_core_eager`: the units run op by op on the card
_EAGER = contextvars.ContextVar("grabcut_eager", default=False)


def programs() -> list:
    """The compiled units kept, every group's."""
    return _UNITS.programs()


def _run(program, *args, **static):
    """A unit: `program(*args, **static)`, a generator function of tensor
    arguments (nests of them, as GMM and Image; an Image first) and
    static Python ones.

    On the CPU, and on the card under `_grabcut_core_eager`, it runs
    eagerly (`drive`). On the card it is compiled once per argument
    shapes and static arguments, in the group of its image, and replayed
    after that (`_UNITS`)."""
    dev = args[0].img.device
    if dev.type != "cuda" or _EAGER.get():
        return drive(program(*args, **static))
    shape = _SHAPE.get() or tuple(args[0].img.shape[:2])
    return _UNITS(dev, shape, program, *args, **static)


def clear_programs() -> None:
    """Drop every compiled unit and release their pools."""
    _UNITS.clear()


def _init_program(im: Image, init_mask: torch.Tensor, seed: int = 42):
    """The program of `_grabcut_init`."""
    fg_w0 = _fg_of(init_mask).reshape(1, -1)
    fg_gmm = yield from _init_gmm(im.pixels, fg_w0, seed)
    bg_gmm = yield from _init_gmm(im.pixels, 1.0 - fg_w0, seed + 1)
    return fg_gmm, bg_gmm


def _grabcut_init(im: Image, init_mask: torch.Tensor, seed: int = 42):
    """GMMs seeded from the init mask (H, W): one lane each. A unit
    (`_run`)."""
    return _run(_init_program, im, init_mask, seed=seed)


def _iter_program(im: Image, masks: torch.Tensor, fg_gmm: GMM, bg_gmm: GMM,
                  cut_y: Optional[torch.Tensor] = None, cut_iters: int = 2500):
    """The program of `_grabcut_iter`: yields the cut's CPLoop."""
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
    cut_loop = CPLoop(unary, im.edge_w, masks == FGD, masks == BGD,
                      max_iter=cut_iters, warm_y=cut_y)
    yield cut_loop
    unknown = (masks == PR_BGD) | (masks == PR_FGD)
    cut = torch.where(cut_loop.u > 0.5, PR_FGD, PR_BGD).to(torch.uint8)
    return (torch.where(unknown, cut, masks), fg_gmm, bg_gmm, cut_loop.y,
            cut_loop.it)


def _grabcut_iter(im: Image, masks: torch.Tensor, fg_gmm: GMM, bg_gmm: GMM,
                  cut_y: Optional[torch.Tensor] = None, cut_iters: int = 2500):
    """One assign/learn/cut alternation for every lane: masks (C, H, W)
    uint8, GMMs of C lanes, cut_y (C, 4, H, W) or None. A unit (`_run`).

    cut_y carries the TV dual state between alternations so each cut
    resumes where the last converged (the GMMs, hence the unary, move
    slowly after the first pass). Returns (masks, fg_gmm, bg_gmm, y, it)."""
    return _run(_iter_program, im, masks, fg_gmm, bg_gmm, cut_y,
                cut_iters=cut_iters)


# --------------------------------------------------------------------------
# standardized mask energy + split-merge polish
# --------------------------------------------------------------------------

def _side_nll(pixels: torch.Tensor, wts: torch.Tensor):
    gmm0 = yield from _init_gmm(pixels, wts, 42)
    comp = _assign(pixels, gmm0)
    gmm = _gmm_from_moments(*_component_moments(pixels, wts, comp, K_COMP))
    return _data_term(pixels, gmm)


def _energy_program(im: Image, fg01: torch.Tensor):
    """The program of `mask_energy`."""
    c, h, w = fg01.shape
    fw = fg01.reshape(c, -1).to(torch.float32)
    nll_fg = yield from _side_nll(im.pixels, fw)
    nll_bg = yield from _side_nll(im.pixels, 1.0 - fw)
    nll = torch.where(fw > 0, nll_fg, nll_bg)
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


def mask_energy(im: Image, fg01: torch.Tensor) -> torch.Tensor:
    """GrabCut energy of hard segmentations fg01 (C, H, W) under GMMs fit
    to each one's own partition by a fixed protocol (kmeans-seeded EM
    refit, seed 42): (C,) float32. The common evaluator the polish and the
    collapse restart judge with. Scoring candidates with the algorithm's
    own GMM likelihoods instead is invalid: overfit tiny-covariance
    components make a worse mask look better.

    A lane's score has the same bits at any lane count: no lane's
    k-means arithmetic depends on another's (`_init_gmm`, every sum over
    points in a fixed order), the moments are exact, and each of its five
    float64 sums reduces a tensor of the lane's own, so the reduction's
    order cannot follow the batch's shape. A unit (`_run`)."""
    return _run(_energy_program, im, fg01)


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
        oh = _one_hot(a, 2) * mw64[..., None]                    # (K, N, 2)
        cnt = oh.sum(dim=1).to(torch.float32)                    # (K, 2)
        newc = torch.matmul(oh.transpose(1, 2), p64).to(torch.float32) \
            / torch.clamp_min(cnt, 1e-6)[..., None]
        cs = torch.where((cnt > 0)[..., None], newc, cs)

    means = gmm.means[0]                                         # (K, 3)
    cnts = (_one_hot(comp, k)
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


def _round_program(im: Image, mask, fg_gmm: GMM, bg_gmm: GMM, y,
                   extra_iters: int):
    """The program of `_polish_round`."""
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
        masks, fgg, bgg, ys, _ = yield from _iter_program(im, masks, fgg, bgg,
                                                          ys)
    es = yield from _energy_program(im, _fg_of(masks))
    es = torch.where(torch.isnan(es), float("inf"), es)
    k = torch.argmin(es).reshape(1)
    pick = lambda t: t.index_select(0, k)  # noqa: E731
    return (pick(masks), _gmm_map(pick, fgg), _gmm_map(pick, bgg), pick(ys),
            pick(es)[0])


def _polish_round(im: Image, mask, fg_gmm: GMM, bg_gmm: GMM, y,
                  extra_iters: int):
    """One split-merge proposal round on one lane (mask (1, H, W), GMMs
    of one lane, y (1, 4, H, W)): build 2K candidate GMM pairs (split each
    FG and each BG component), continue each for `extra_iters` batched
    alternations, and take the one of least standardized energy. Returns
    the winner's (mask, fg_gmm, bg_gmm, y, energy), each of one lane;
    nothing is read on the host. A unit (`_run`).

    The JAX package ranks with its vmapped evaluator and confirms the
    winner with the unbatched one, because the two round differently. The
    port's `mask_energy` gives a lane the same bits at any lane count, so
    the ranking score is the confirmed one."""
    return _run(_round_program, im, mask, fg_gmm, bg_gmm, y,
                extra_iters=int(extra_iters))


def _accepted_round_program(im: Image, mask, fg_gmm: GMM, bg_gmm: GMM, y,
                            e_inc, extra_iters: int):
    """A polish round and its acceptance, one program: the carried state
    (mask, GMMs, y, energy) after the round, the winner's where it
    strictly improves on `e_inc`, and the accept flag."""
    m_c, fg_c, bg_c, y_c, e_c = yield from _round_program(
        im, mask, fg_gmm, bg_gmm, y, extra_iters)
    acc = _accepts_dev(e_c, e_inc)
    return (torch.where(acc, m_c, mask), _where_gmm(acc, fg_c, fg_gmm),
            _where_gmm(acc, bg_c, bg_gmm), torch.where(acc, y_c, y),
            torch.where(acc, e_c, e_inc), acc)


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
    and carry decision is a device-side select, inside the round's
    program."""
    if search_max_dim is None:
        search_max_dim = DEFAULTS.grabcut_polish_search_dim
    h, w = mask.shape[1:]
    extra_iters = int(extra_iters)

    if max(h, w) <= int(search_max_dim):
        e_inc = mask_energy(im, _fg_of(mask))[0]
        for r in range(int(rounds)):
            mask, fg_gmm, bg_gmm, y, e_inc, acc = _run(
                _accepted_round_program, im, mask, fg_gmm, bg_gmm, y, e_inc,
                extra_iters=extra_iters)
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
        mask_s, fg_s, bg_s, y_s, e_s, acc = _run(
            _accepted_round_program, im_s, mask_s, fg_s, bg_s, y_s, e_s,
            extra_iters=extra_iters)
        any_acc = any_acc | acc
        if r == 0 and not bool(acc):  # host read 1: exact early exit
            return mask

    # host read 2: skip the full-resolution continuation (and its two
    # full-resolution evaluator refits) when no coarse round improved
    if not bool(any_acc):
        return mask

    m_f, fg_f, bg_f, y_f = mask, fg_s, bg_s, y
    for _ in range(extra_iters):
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

    On the card the units (init, one alternation, the energy, a polish
    round) run compiled, each captured as CUDA graphs at its first call
    with new shapes and replayed after that (`_run`); the units of the
    last `compiled.PROGRAM_SHAPES` image shapes are kept. On the CPU
    they run eagerly. Both give the same bytes.
    """
    token = _SHAPE.set(tuple(int(n) for n in img_bgr.shape[:2]))
    try:
        return _grabcut(img_bgr, init_mask, iterations, seed, splitmerge,
                        resolve_device(device))
    finally:
        _SHAPE.reset(token)


def _grabcut(img_bgr, init_mask, iterations, seed, splitmerge, dev):
    """`grabcut_core` on `dev`."""
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


def _grabcut_core_eager(img_bgr, init_mask, iterations: Optional[int] = None,
                        seed: int = 42, splitmerge: Optional[bool] = None,
                        device="cuda"):
    """`grabcut_core` with every unit run op by op, never from a graph:
    the plain counterpart of the compiled run on the card, with its
    bytes. The CPU runs this path anyway."""
    token = _EAGER.set(True)
    try:
        return grabcut_core(img_bgr, init_mask, iterations=iterations,
                            seed=seed, splitmerge=splitmerge, device=device)
    finally:
        _EAGER.reset(token)
