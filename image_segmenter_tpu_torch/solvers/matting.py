"""Closed-form matting: matrix-free Levin Laplacian + Jacobi-preconditioned CG.

Counterpart of image_segmenter_tpu/solvers/matting.py, batched over
images. The Laplacian is never assembled: per-window factors are built
once per solve (`_precompute`) and L @ p is applied in every iteration
(`_matvec`). Window statistics are accumulated in centred, residual form,
because the E[I^2] - mu^2 form cancels in float32 against the eps = 1e-7
ridge.

Two formulations, as in the JAX package:
- half_stats, radius 1, float32 (the throughput pipeline): kernel K2
  (kernels/precompute) builds the packed LDL factors and kernel K3
  (kernels/matvec) applies L @ p; on a CPU tensor their plain versions.
- every other case (the full (3, 3) window inverse that the compat path
  `estimate_alpha_cf` solves with, another radius, float64): the plain
  PyTorch formulation on the tensors' device, as the JAX package runs it
  outside any Pallas kernel. The floats of the two differ, so the compat
  path is not routed through K2 and K3.

The JAX package runs one image's CG in a `lax.while_loop` and vmaps it
over the batch; under vmap each image freezes once its own condition is
false. Here the batch axis is written out: every iteration runs the body
for the whole batch and keeps the new state only for images still active,
so each image stops at the iteration count it has in JAX. The loop runs
in chunks of `CG_CHUNK` iterations with the state in place (`CGLoop`):
eagerly the host reads the stop flag once a chunk, and the compiled
pipeline (pipeline/compiled.py) replays a captured chunk until the flag
clears, the counterpart of the JAX package's `lax.while_loop`.

`mesh=` splits a solve's rows over the space slots of a (1, S) mesh
(parallel/mesh.py), where the JAX package gets the same from GSPMD on
row-sharded inputs: each slot runs the precompute (K2) and every matvec
(K3) on its row block with ghost rows, the sums add float64 partials, and
one stop decision serves every slot (`CGLoop`).

The JAX package sends only solves of at most 2.5 MP to its fused matvec,
because the TPU kernel's overlap-tiled operand stack cost extra device
memory. The CUDA kernel reads K2's planes in place and needs no extra
buffer, so the port has no such cap.

float64. The JAX package emulates float64 on the TPU with compensated
float32 pairs (solvers/matting_dd.py) and otherwise solves on the host.
CUDA has native float64, so the polish and the x64 rung of
`estimate_alpha_cf` are this module's solver on float64 tensors, on the
device of the input; the emulation is not ported.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from image_segmenter_tpu_torch.kernels.matvec import laplacian_matvec_plain, \
    matvec_planes
from image_segmenter_tpu_torch.kernels.precompute import precompute_planes, \
    window_factors
from image_segmenter_tpu_torch.ops.resize import resize_linear_aa
from image_segmenter_tpu_torch.parallel.mesh import SPACE_AXIS, split_bounds, \
    take, to_slot
from image_segmenter_tpu_torch.utils.backend import resolve_device, true_div

_LAMBDA = 100.0  # pymatting's known-constraint weight
# CG iterations between two reads of the stop flag. A chunk wastes up to
# CG_CHUNK - 1 masked iterations of the slowest image's solve and saves a
# host read and its idle gap on each of the others; 8 divides the main
# path's cap of 200 (bench/sweep_chunks.py measures the choice).
CG_CHUNK = 8


class _Precomp(NamedTuple):
    image: torch.Tensor     # (B, 3, H, W)
    n: torch.Tensor         # (B, H, W) window size == windows covering a pixel
    mu: torch.Tensor        # (B, 3, H, W) window means
    dinv: torch.Tensor      # (B, 6, H, W): packed LDL factors, or the six
                            # entries of the symmetric window inverse
    packed: bool            # which of the two `dinv` holds
    diag: torch.Tensor      # (B, H, W) diag(L)
    rankdef: torch.Tensor   # (B, H, W) bool: window exactly rank-deficient
    planes: Optional[torch.Tensor] = None  # K2's (B, 12, H, W) output when
                            # that path ran; K3 reads it in place


def _bcast(x: torch.Tensor) -> torch.Tensor:
    return x[:, None, None]


class _Rows:
    """A per-image field (B, H, W) of a solve, split by rows over its
    slots: one block a slot, on the slot's device. Arithmetic maps over the
    blocks; a (B,) tensor of per-image values (held on the first slot)
    multiplies each block on its own device. An unsplit solve has one
    block, and every operation is the one it would run on the tensor."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def _zip(self, other, f):
        if isinstance(other, _Rows):
            return _Rows(f(a, b) for a, b in zip(self.blocks, other.blocks))
        return _Rows(f(a, other) for a in self.blocks)

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._zip(other, lambda a, b: a * b)

    def __rmul__(self, s):
        """s * field for a float or a (B,) tensor of per-image values."""
        if isinstance(s, torch.Tensor):
            return _Rows(_bcast(to_slot(s, a.device)) * a for a in self.blocks)
        return _Rows(s * a for a in self.blocks)

    def gather(self) -> torch.Tensor:
        """The whole (B, H, W) field on the first slot."""
        if len(self.blocks) == 1:
            return self.blocks[0]
        dev = self.blocks[0].device
        return torch.cat([to_slot(a, dev) for a in self.blocks], dim=1)


def _where(mask: torch.Tensor, a: _Rows, b: _Rows) -> _Rows:
    """Per image: a where the (B,) mask holds, else b."""
    return _Rows(torch.where(_bcast(to_slot(mask, x.device)), x, y)
                 for x, y in zip(a.blocks, b.blocks))


def _bsum(x: _Rows) -> torch.Tensor:
    """Per-image sum over (H, W): (B,) in x's type, on the first slot.

    A float32 x is accumulated in float64 (each slot's partial, then the
    partials added on the first slot) and rounded once: a float32 sum
    rounds by its order of additions, which differs between the CPU and
    the card and between one slot and several, and the CG's step sizes and
    stopping test read these sums every iteration. Rounded from float64
    they are the same on both devices and at any split (up to a tie at
    float64 precision), so the solve is too. A float64 x has no wider type
    to go to: the float64 rungs agree between devices to rounding, not to
    bits."""
    first = x.blocks[0].device
    total = None
    for a in x.blocks:
        part = to_slot(a.sum(dim=(1, 2), dtype=torch.float64), first)
        total = part if total is None else total + part
    return total.to(x.blocks[0].dtype)


def _precompute(img_planes: torch.Tensor, epsilon, radius: int = 1,
                half_stats: bool = False) -> _Precomp:
    """Window statistics and (Sigma_k + eps/n I)^-1 per centre of a
    (B, 3, H, W) image. half_stats at radius 1 in float32 takes kernel K2
    (its plain version on the CPU); everything else the plain
    formulation, with the full inverse unless half_stats."""
    if (half_stats and radius == 1 and img_planes.dtype == torch.float32):
        planes = precompute_planes(img_planes, epsilon)
        return _Precomp(img_planes, planes[:, 7], planes[:, 8:11],
                        planes[:, 0:6], True, planes[:, 6],
                        planes[:, 11] > 0.5, planes)
    f = window_factors(img_planes, epsilon, radius)
    return _Precomp(img_planes, f.n, f.mu, f.ldl if half_stats else f.inv,
                    half_stats, f.diag, f.rankdef)


def _matvec(pre: _Precomp, p: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """L @ p for a batch: kernel K3 where K2 built the planes, else the
    plain formulation for packed or full factors."""
    if pre.planes is not None:
        return matvec_planes(pre.planes, pre.image, p)
    return laplacian_matvec_plain(pre.image, pre.n, pre.mu, pre.dinv, p,
                                  radius, pre.packed)


class _Slab(NamedTuple):
    """What one slot of a solve holds: the precompute of its row block
    extended by 2 * radius image rows on each interior edge, and where
    its own rows sit in that extension."""
    dev: torch.device
    rows: tuple          # (first, past-last) own rows in the image
    ext: tuple           # (first, past-last) rows of the extension
    pre: _Precomp

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The own rows of an extension-sized (B, ..., H_ext, W) tensor."""
        off = self.rows[0] - self.ext[0]
        return t.narrow(t.dim() - 2, off, self.rows[1] - self.rows[0])


def _space_slots(mesh) -> list:
    """The space slots of a one-group (1, S) mesh, in row order."""
    if mesh.shape[0] != 1 or mesh.axis_names[1] != SPACE_AXIS:
        raise ValueError(f"the solve splits rows over the space axis of one "
                         f"data group: pass a (1, S) (data, space) mesh such "
                         f"as mesh.group(i), got {mesh}")
    return list(mesh.devices[0])


class CGLoop:
    """The batched CG as a loop its caller drives: the constructor runs
    the precompute and the first residual, `step` runs `CG_CHUNK`
    iterations on the solve's devices, `flag` (a 0-dim bool on the first slot) says
    whether any image is still active, and `finish` returns (alpha, ok,
    it, res, rankdef_frac), where rankdef_frac (B,) is the unknown-band
    exact-rank-deficiency fraction from the same precompute the solve
    uses.

    The loop-carried state (x, r, p, rz, pending, it, active and the flag)
    lives in buffers that `step` writes in place, so a step captured in a
    CUDA graph reads and writes the same addresses on every replay
    (pipeline/compiled.py). An image that stops inside a chunk keeps its
    state through the rest of the chunk, as under the JAX package's
    vmapped `while_loop`: any chunk size gives the same bits and counts.

    With a mesh the image rows split over its space slots (torch.
    tensor_split sizes). Each slot precomputes its block extended by
    2 * radius image rows on each interior edge: a window centred up to
    `radius` rows past the block reads image rows `radius` further out.
    At the two chain ends the block starts at the image border, whose
    windows count their pixels through the zero-padded ones mask, so no
    ghost rows go there (zero rows would change those counts). Every
    iteration copies the 2 * radius rows of the matvec's operand next to
    each interior edge from the neighbours, applies L on the extension
    and keeps the own rows. The per-image sums add float64 partials on
    the first slot (`_bsum`), and the loop's stop is one decision made
    there. Outputs are on the first slot; they are the unsplit solve's
    bits on the test cases, since every pixel's arithmetic is the same
    and the sums round once from float64."""

    def __init__(self, image01: torch.Tensor, trimap: torch.Tensor,
                 epsilon=1e-7, radius: int = 1, lam=_LAMBDA,
                 rtol: float = 1e-5, max_iter: int = 400,
                 x0: Optional[torch.Tensor] = None, half_stats: bool = False,
                 mesh=None):
        dt = torch.float64 if image01.dtype == torch.float64 \
            else torch.float32
        img = image01.to(dt).permute(0, 3, 1, 2)
        trimap = trimap.to(dt)
        h = img.shape[2]
        devs = [image01.device] if mesh is None else _space_slots(mesh)
        if len(devs) > h:
            raise ValueError(f"{h} rows cannot split over {len(devs)} slots")
        bounds = split_bounds(h, len(devs))
        halo = 2 * radius
        slabs = []
        for dev, (r0, r1) in zip(devs, bounds):
            e0, e1 = max(0, r0 - halo), min(h, r1 + halo)
            blk = to_slot(img[:, :, e0:e1], dev).contiguous()
            slabs.append(_Slab(dev, (r0, r1), (e0, e1),
                               _precompute(blk, epsilon, radius, half_stats)))
        self.slabs, self.bounds, self.radius, self.lam = \
            slabs, bounds, radius, lam
        self.rtol, self.max_iter = rtol, max_iter

        def rows(t):  # a (B, H, W) tensor split over the slots
            return _Rows(to_slot(t[:, r0:r1], sl.dev)
                         for sl, (r0, r1) in zip(slabs, bounds))

        self.tri = tri = rows(trimap)
        self.is_known = is_known = _Rows(((t < 0.1) | (t > 0.9)).to(dt)
                                         for t in tri.blocks)
        known_fg = _Rows((t > 0.9).to(dt) for t in tri.blocks)
        self.b = b = lam * known_fg
        # diag(L) > 0 mathematically; f32 can round tiny entries negative,
        # which would flip the Jacobi preconditioner's sign — clamp.
        self.m_inv = _Rows(
            1.0 / torch.clamp_min(sl.own(sl.pre.diag) + lam * k, 1e-6)
            for sl, k in zip(slabs, is_known.blocks))

        if x0 is None:
            x0 = _Rows(t.clone() for t in tri.blocks)
        else:
            x0 = _Rows(torch.where(k > 0, t, torch.clamp(x.to(dt), 0.0, 1.0))
                       for k, t, x in zip(is_known.blocks, tri.blocks,
                                          rows(x0).blocks))
        r0 = b - self._amv(x0)
        z0 = self.m_inv * r0
        self.bnorm = torch.sqrt(_bsum(b * b)) + 1e-30
        nb = image01.shape[0]
        self.dev = devs[0]
        # the loop-carried state, updated in place by `step`
        self.x, self.r, self.p = x0, r0, z0
        self.rz = _bsum(r0 * z0)
        self.pending = torch.zeros(nb, dtype=torch.bool, device=self.dev)
        self.it = torch.zeros(nb, dtype=torch.int32, device=self.dev)
        self.active = self._cond(self.r, self.it)
        self.flag = self.active.any()

    def _amv(self, q: _Rows) -> _Rows:
        """(L + lam C) q."""
        lq = _Rows(sl.own(_matvec(sl.pre, take(q.blocks, self.bounds, *sl.ext,
                                                sl.dev, dim=1), self.radius))
                   for sl in self.slabs)
        return lq + self.lam * self.is_known * q

    def _cond(self, r: _Rows, it: torch.Tensor) -> torch.Tensor:
        res = torch.sqrt(_bsum(r * r)) / self.bnorm
        # a non-finite residual means the system is beyond f32 CG: exit
        # and report not converged (the compat retry ladder takes over)
        return (res > self.rtol) & (it < self.max_iter) & torch.isfinite(res)

    def _body(self, x, r, p, rz, pending):
        # One matvec per iteration. A curvature at the f32 noise floor
        # (`broke`) defers an exact-residual restart to the next
        # iteration, whose matvec is applied to x (`pending`) instead of p.
        y = self._amv(_where(pending, x, p))
        r_r = self.b - y                                # restart lane
        pap = _bsum(p * y)
        broke = ~(pap > 1e-10 * _bsum(p * p))
        step = rz / torch.where(broke, 1.0, pap)
        x_a = x + step * p                              # advance lane
        r_a = r - step * y
        take_restart = pending
        take_advance = (~pending) & (~broke)
        x2 = _where(take_advance, x_a, x)
        r2 = _where(take_restart, r_r, _where(take_advance, r_a, r))
        z = self.m_inv * r2
        rz2 = _bsum(r2 * z)
        beta = torch.where(take_advance, rz2 / torch.clamp_min(rz, 1e-30), 0.0)
        p2 = _where(take_restart | take_advance, z + beta * p, p)
        rz3 = torch.where(take_restart | take_advance, rz2, rz)
        return x2, r2, p2, rz3, broke & ~pending

    def step(self) -> None:
        """`CG_CHUNK` iterations; images no longer active keep their state.
        No host read: a CUDA graph can capture it."""
        x, r, p, rz = self.x, self.r, self.p, self.rz
        pending, it, active = self.pending, self.it, self.active
        for _ in range(CG_CHUNK):
            x2, r2, p2, rz2, pending2 = self._body(x, r, p, rz, pending)
            x = _where(active, x2, x)
            r = _where(active, r2, r)
            p = _where(active, p2, p)
            rz = torch.where(active, rz2, rz)
            pending = torch.where(active, pending2, pending)
            it = it + active.to(torch.int32)
            active = self._cond(r, it)
        for dst, src in ((self.x, x), (self.r, r), (self.p, p)):
            for a, b in zip(dst.blocks, src.blocks):
                a.copy_(b)
        for dst, src in ((self.rz, rz), (self.pending, pending),
                         (self.it, it), (self.active, active)):
            dst.copy_(src)
        torch.any(active, out=self.flag)

    def run(self) -> None:
        """Step until no image is active: one host read a chunk, one stop
        decision for every slot, from the summed residual."""
        while bool(self.flag):
            self.step()

    def finish(self):
        """(alpha, ok, it, res, rankdef_frac) from the current state."""
        res = torch.sqrt(_bsum(self.r * self.r)) / self.bnorm
        alpha = torch.clamp(self.x.gather(), 0.0, 1.0)
        n_def = n_unk = None
        for sl, t in zip(self.slabs, self.tri.blocks):
            unk = (t > 0.1) & (t < 0.9)
            d = to_slot((sl.own(sl.pre.rankdef) & unk).sum(dim=(1, 2)),
                        self.dev)
            u = to_slot(unk.sum(dim=(1, 2)), self.dev)
            n_def, n_unk = (d, u) if n_def is None else (n_def + d, n_unk + u)
        frac = n_def / torch.clamp_min(n_unk, 1)
        return alpha, res <= self.rtol, self.it.clone(), res, frac


def _solve_impl(image01: torch.Tensor, trimap: torch.Tensor, epsilon,
                radius: int, lam, rtol: float, max_iter: int,
                x0: Optional[torch.Tensor], half_stats: bool, mesh=None):
    """The whole solve: (alpha, ok, it, res, rankdef_frac) (`CGLoop`)."""
    loop = CGLoop(image01, trimap, epsilon, radius, lam, rtol, max_iter, x0,
                  half_stats, mesh)
    loop.run()
    return loop.finish()


def solve_alpha_cf(image01: torch.Tensor, trimap: torch.Tensor,
                   epsilon=1e-7, radius: int = 1, lam=_LAMBDA,
                   rtol: float = 1e-5, max_iter: int = 400,
                   x0: Optional[torch.Tensor] = None,
                   half_stats: bool = False, mesh=None):
    """Solve (L + lam*C) alpha = lam*known_fg per image, alpha in [0, 1].

    image01 (B, H, W, 3) float32 or float64 in [0, 1] (the solve runs in
    its type); trimap (B, H, W) (0 = BG, 1 = FG, 0.5 = unknown); x0
    optional (B, H, W) warm start (knowns are clamped to the trimap). In
    float32 the per-window ridge is max(epsilon, 1e-5 * tr(Z'Z)); float64
    inputs get the exact-epsilon operator, as the compat ladder's
    reference-precision rungs need. half_stats stores the window inverse
    as its six LDL factors (and, at radius 1 in float32, takes kernels K2
    and K3).

    mesh: a (1, S) (data, space) mesh (parallel/mesh.py; `mesh.group(i)`
    of a larger one) whose S slots each solve a block of the rows, with
    ghost rows exchanged every iteration (see `_solve_impl`); the outputs
    are on its first slot. None solves on the input's device.

    Returns (alpha (B, H, W), converged (B,) bool, iterations (B,) int32,
    rel_residual (B,)).
    """
    return _solve_impl(image01, trimap, epsilon, radius, lam, rtol, max_iter,
                       x0, half_stats, mesh)[:4]


def solve_alpha_cf_with_conditioning(image01, trimap, epsilon=1e-7,
                                     radius: int = 1, lam=_LAMBDA,
                                     rtol: float = 1e-5, max_iter: int = 400,
                                     x0=None, half_stats: bool = False,
                                     mesh=None):
    """`solve_alpha_cf` plus the unknown-band rank-deficiency fraction
    (B,) as a fifth output, from the solve's own precompute."""
    return _solve_impl(image01, trimap, epsilon, radius, lam, rtol, max_iter,
                       x0, half_stats, mesh)


_PYRAMID_MIN_DIM = 400  # coarsest level's max dimension stays >= this / 2
_RANKDEF_ROUTE_FRAC = 0.1  # unknown-band rank-deficiency above this -> f64


def rank_deficient_fraction(image01: torch.Tensor, trimap: torch.Tensor,
                            epsilon=1e-7, radius: int = 1) -> torch.Tensor:
    """Fraction (B,) of unknown-band window centres that are exactly rank
    deficient (pre-ridge smallest LDL pivot ~ 0 despite non-trivial colour
    spread). Quantized or posterised images score high (colour boundaries
    are noise-free rank-1 windows); photographs score near 0 (sensor noise
    keeps every pivot positive). The compat path gets this from the solve
    itself (`solve_alpha_cf_with_conditioning`)."""
    dt = torch.float64 if image01.dtype == torch.float64 else torch.float32
    pre = _precompute(image01.to(dt).permute(0, 3, 1, 2).contiguous(),
                      epsilon, radius)
    unk = (trimap > 0.1) & (trimap < 0.9)
    return (pre.rankdef & unk).sum(dim=(1, 2)) \
        / torch.clamp_min(unk.sum(dim=(1, 2)), 1)


def _coarse_level(image01: torch.Tensor, trimap: torch.Tensor,
                  nh: int, nw: int):
    """Half-resolution (image, trimap) for the solve pyramid.

    The coarse trimap is conservative: a coarse pixel is known FG or BG
    only where the resampled known indicator is (numerically) all-known,
    so the coarse solve never constrains a region that is mixed at fine
    scale."""
    dt = image01.dtype
    img_s = resize_linear_aa(image01, (nh, nw))
    fg = resize_linear_aa((trimap > 0.9).to(dt), (nh, nw))
    bg = resize_linear_aa((trimap < 0.1).to(dt), (nh, nw))
    tri_s = torch.where(fg > 0.999, 1.0, torch.where(bg > 0.999, 0.0, 0.5))
    return img_s, tri_s.to(dt)


def _upsample_alpha(alpha: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    return resize_linear_aa(alpha, (nh, nw))


def _solve_pyramid(img, tri, epsilon, radius, max_iter, rtol=1e-5):
    """Coarse-to-fine solve of a (B, H, W, 3) batch; returns the finest
    level's (alpha, ok, it, res, rankdef_frac)."""
    levels = [(img, tri)]
    while max(levels[-1][1].shape[1:]) > _PYRAMID_MIN_DIM:
        fh, fw = levels[-1][1].shape[1:]
        nh, nw = max(fh // 2, 1), max(fw // 2, 1)
        levels.append(_coarse_level(levels[-1][0], levels[-1][1], nh, nw))

    x0 = None
    for li, (im_l, tri_l) in enumerate(reversed(levels)):
        if li == len(levels) - 1:
            return solve_alpha_cf_with_conditioning(
                im_l, tri_l, epsilon=epsilon, radius=radius,
                max_iter=max_iter, rtol=rtol, x0=x0)
        alpha = solve_alpha_cf(im_l, tri_l, epsilon=epsilon, radius=radius,
                               max_iter=max_iter, rtol=rtol, x0=x0)[0]
        # Coarse levels are warm-start producers only; even a partially
        # converged coarse alpha beats the raw trimap as x0.
        fh, fw = levels[len(levels) - 2 - li][1].shape[1:]
        x0 = _upsample_alpha(alpha, fh, fw)


# Diagnostics of the most recent estimate_alpha_cf call.
LAST_SOLVE_INFO: dict = {}

# fl32(n / 255) for n in 0..255: the float32 image plane of a u8 image,
# bit-identical to np.asarray(u8 / 255.0, np.float32)
_U8_TABLE = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)


def _as_u8_exact(image01):
    """The u8 array `u` with image01 == u/255 exactly (f64), else None."""
    x = np.asarray(image01)
    if x.dtype == np.uint8:
        return x
    x = np.asarray(x, np.float64)
    if x.size == 0 or x.min() < 0.0 or x.max() > 1.0:
        return None
    u = np.rint(x * 255.0)
    if np.array_equal(x, u / 255.0):
        return u.astype(np.uint8)
    return None


def _tri_codes(trimap):
    """u8 codes {0,1,2} for a {0,0.5,1} trimap, else None."""
    t = np.asarray(trimap, np.float64)
    if np.all((t == 0.0) | (t == 0.5) | (t == 1.0)):
        return (t * 2.0).astype(np.uint8)
    return None


def estimate_alpha_cf(image01, trimap, laplacian_kwargs=None, cg_kwargs=None,
                      x64=False, polish=None, device="cuda"):
    """pymatting-compatible entry point: (H, W, 3) image in [0, 1] and
    (H, W) trimap as numpy arrays -> (H, W) float64 alpha.

    Raises ValueError on non-convergence so the compat layer's retry
    ladder engages as the reference's except paths do.

    Above _PYRAMID_MIN_DIM the solve runs coarse-to-fine: each level's
    alpha, upsampled, warm-starts the next. The fine operator and the
    convergence test are unchanged.

    The float32 rung runs first. When the unknown band's rank-deficiency
    fraction flags a quantized-flat input its result is discarded and the
    float64 rung runs instead (also with x64=True): the same solver on
    float64 tensors, exact-epsilon operator, pymatting's rtol 1e-7.

    polish (default config DEFAULTS.matting_f64_polish): after a certified
    float32 solve, a float64 CG warm-started at the float32 alpha runs
    against the exact-epsilon operator at rtol 1e-7; only a certified
    polish replaces the float32 answer.

    Both float64 rungs run on `device`, where the float32 rung ran: there
    is no hop to the CPU when the input is on the card.
    """
    dev = resolve_device(device)
    lk = dict(laplacian_kwargs or {})
    ck = dict(cg_kwargs or {})
    epsilon = float(lk.get("epsilon", 1e-7))
    radius = int(lk.get("radius", 1))
    if polish is None:
        from image_segmenter_tpu_torch import config

        polish = config.DEFAULTS.matting_f64_polish
    LAST_SOLVE_INFO.clear()

    # u8 ingest: compat callers build image01 as u8 / 255 and a {0, 0.5, 1}
    # trimap, so ship the u8 image and the trimap codes once and expand
    # them on the device: the same float32 and float64 planes at a fraction
    # of the transferred bytes, shared by every rung.
    u8_host = _as_u8_exact(image01)
    codes_host = _tri_codes(trimap) if u8_host is not None else None
    u8_dev = codes_dev = None
    if codes_host is not None:
        u8_dev = torch.from_numpy(np.ascontiguousarray(u8_host)).to(dev)
        codes_dev = torch.from_numpy(codes_host).to(dev)

    def planes(dt):
        """(1, H, W, 3) image and (1, H, W) trimap on `dev` in type dt."""
        if codes_dev is not None:
            if dt == torch.float32:
                img = torch.from_numpy(_U8_TABLE).to(dev)[u8_dev.long()]
            else:
                img = true_div(u8_dev.to(dt), 255.0)
            return img[None], (codes_dev.to(dt) * 0.5)[None]
        npdt = np.float32 if dt == torch.float32 else np.float64
        return (torch.from_numpy(np.asarray(image01, npdt)).to(dev)[None],
                torch.from_numpy(np.asarray(trimap, npdt)).to(dev)[None])

    t0 = time.perf_counter()
    if not x64:
        # The float32 fast path; its solve carries the unknown-band
        # rank-deficiency fraction. A quantized-flat input makes the f32
        # operator ridge-biased and leaves near-null modes unpinned at
        # rtol 1e-5, so when the statistic flags it the f32 result is
        # discarded and the reference-precision rung runs instead.
        img_f32, tri_f32 = planes(torch.float32)
        alpha_dev, ok, it, res, frac = _solve_pyramid(
            img_f32, tri_f32, epsilon, radius,
            int(ck.get("maxiter", 400)), rtol=float(ck.get("rtol", 1e-5)))
        if float(frac[0]) > _RANKDEF_ROUTE_FRAC:
            x64 = True
        else:
            alpha = alpha_dev[0].cpu().numpy().astype(np.float64)
            LAST_SOLVE_INFO.update(t_f32=time.perf_counter() - t0,
                                   f32_iters=int(it[0]))
            if polish and bool(ok[0]):
                t1 = time.perf_counter()
                img_f64, tri_f64 = planes(torch.float64)
                alpha_p, ok_p, it_p, _ = solve_alpha_cf(
                    img_f64, tri_f64, epsilon=epsilon, radius=radius,
                    max_iter=int(ck.get("maxiter", 10000)),
                    rtol=float(ck.get("rtol", 1e-7)),
                    x0=alpha_dev.to(torch.float64))
                ok_p = bool(ok_p[0])  # waits for the device before the timer
                LAST_SOLVE_INFO.update(t_polish=time.perf_counter() - t1,
                                       polish_iters=int(it_p[0]),
                                       polish_converged=ok_p,
                                       polish_backend="f64")
                if ok_p:
                    # only a certified polish replaces a certified f32 answer
                    alpha = alpha_p[0].cpu().numpy()

    if x64:
        # pymatting's own CG defaults (rtol 1e-7, maxiter 10000): on
        # near-singular systems a 1e-5 residual does not pin down the
        # near-null alpha modes.
        img_f64, tri_f64 = planes(torch.float64)
        alpha_dev, ok, it, res, _ = _solve_pyramid(
            img_f64, tri_f64, epsilon, radius,
            int(ck.get("maxiter", 10000)), rtol=float(ck.get("rtol", 1e-7)))
        alpha = alpha_dev[0].cpu().numpy()

    if not bool(ok[0]):
        raise ValueError(
            "closed-form matting CG did not converge: rel_residual="
            f"{float(res[0]):.3e} after {int(it[0])} iterations")
    return alpha
