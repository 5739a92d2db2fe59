"""Weighted k-means: the deterministic fit of the pipeline, batched over
images, and the seeded fit with restarts of the colour quantizers.

Counterpart of image_segmenter_tpu/solvers/kmeans.py: `kmeans_fit_det`
(stratified greedy-potential seeding + one Lloyd run, no PRNG),
`kmeans_fit` (greedy kmeans++ from jax.random's stream, `n_init`
restarts, the best inertia wins), `assign_labels` and `map_to_centers`.

`kmeans_fit_det`, `assign_labels` and `map_to_centers` take a leading
batch axis. The JAX package vmaps the Lloyd `while_loop` over images,
where each image freezes once its own shift is within tolerance; the port
keeps a per-image active mask and reads it on the host once per
iteration, so each image runs the iterations it runs in JAX.

`kmeans_fit` takes one point set, as in the JAX package. Its restarts
are a leading axis of the centres: all of them advance in lock step over
one pass of the points, a converged restart is frozen, and the sequential
path is the same code on one restart at a time, so the two give the same
bits. Its points are LAB or HSV coordinates or colours weighted by large
counts, so no sum is exact: every sum over points runs in a fixed order
(pairwise inside a block of points, then block after block), and the fit
does not depend on how torch orders a reduction on a device. The host
reads two flags once per Lloyd iteration (any restart still moving, any
cluster empty).

Ties follow JAX: `argmin`/`argmax` take the first index, and `lax.top_k`'s
lowest-index-first order is a stable descending sort.

The fit is the same on the CPU and on the card: distances are elementwise
float32 arithmetic, the sums that pick a seed or the stopping point run in
a fixed order (ops/scan.py), and the Lloyd sums add integer-valued terms,
which are exact in any order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from image_segmenter_tpu_torch.ops.scan import cumsum, tree_sum
from image_segmenter_tpu_torch.utils import prng as PRNG
from image_segmenter_tpu_torch.utils.backend import true_div

_BLOCK = 1 << 17  # 131072 points per assignment block


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (B, k, d) float32; (k, d) from kmeans_fit
    inertia: torch.Tensor  # (B,) float32; () from kmeans_fit


def _pad_points(points: torch.Tensor, weights: torch.Tensor):
    """Pad N to a multiple of the block size with zero-weight points:
    (B, N, d), (B, N) -> (B, nb, block, d), (B, nb, block). Small inputs
    get one right-sized block."""
    bsz, n, d = points.shape
    block = min(_BLOCK, max(1024, -(-n // 1024) * 1024))
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        points = torch.nn.functional.pad(points, (0, 0, 0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    return points.reshape(bsz, nb, block, d), weights.reshape(bsz, nb, block)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0*b0 + a1*b1) + a2*b2 over the last axis of broadcast operands."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _pairwise_d2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances (B, n, k) via |x|^2 - 2 x.c + |c|^2 (d = 3). The
    product x.c is three elementwise float32 multiply-adds: full float32
    precision, as the JAX package's HIGHEST-precision dot, and the same
    bits on every device."""
    xc = _dot3(x[:, :, None, :], c[:, None, :, :])
    x2 = _dot3(x, x)[..., None]
    c2 = _dot3(c, c)[:, None, :]
    return torch.clamp_min(x2 - 2.0 * xc + c2, 0.0)


def _min_d2_blocked(pts, w, centers) -> torch.Tensor:
    """Per-point min distance^2 to any center, zeroed for w == 0:
    (B, nb, block)."""
    return torch.stack(
        [_pairwise_d2(pts[:, i], centers).amin(dim=2) * (w[:, i] > 0)
         for i in range(pts.shape[1])], dim=1)


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, lowest index first on
    ties (lax.top_k's order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, d), idx (B, m) -> (B, m, d)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _lloyd(pts, w, centers, max_iter: int, tol: torch.Tensor) -> KMeansResult:
    """Weighted Lloyd iterations until shift^2 <= tol, per image."""
    bsz, nb, blk, d = pts.shape
    k = centers.shape[1]
    flatp = pts.reshape(bsz, nb * blk, d)

    def assign_stats(centers):
        sums = torch.zeros((bsz, k, d), dtype=torch.float32, device=pts.device)
        counts = torch.zeros((bsz, k), dtype=torch.float32, device=pts.device)
        inertia = torch.zeros((bsz,), dtype=torch.float32, device=pts.device)
        for i in range(nb):
            pb, wb = pts[:, i], w[:, i]
            d2 = _pairwise_d2(pb, centers)
            lbl = torch.argmin(d2, dim=2)
            onehot = torch.nn.functional.one_hot(lbl, k).to(torch.float32) \
                * wb[..., None]
            # exact f32 sums of the (integer-valued) points per cluster
            sums = sums + (onehot[..., None] * pb[:, :, None, :]).sum(dim=1)
            counts = counts + onehot.sum(dim=1)
            inertia = inertia + (d2.amin(dim=2) * wb).sum(dim=1)
        return sums, counts, inertia

    def reseed_empty(centers, counts):
        """Move empty clusters onto the current farthest points: the i-th
        empty slot takes the i-th farthest point."""
        md = _min_d2_blocked(pts, w, centers).reshape(bsz, -1)
        far_pts = _gather_rows(flatp, _top_k_indices(md, k))   # (B, k, d)
        empty = counts == 0
        slot = torch.clamp(torch.cumsum(empty.to(torch.int32), dim=1) - 1,
                           0, k - 1)
        return torch.where(empty[..., None],
                           _gather_rows(far_pts, slot.to(torch.int64)),
                           centers)

    shift2 = torch.full((bsz,), float("inf"), device=pts.device)
    it = torch.zeros((bsz,), dtype=torch.int32, device=pts.device)
    active = (shift2 > tol) & (it < max_iter)
    while bool(active.any()):
        sums, counts, _ = assign_stats(centers)
        new = torch.where(counts[..., None] > 0,
                          sums / torch.clamp_min(counts, 1.0)[..., None],
                          centers)
        new = reseed_empty(new, counts)
        shift = new - centers
        s2 = tree_sum((shift * shift).reshape(bsz, -1))
        centers = torch.where(active[:, None, None], new, centers)
        shift2 = torch.where(active, s2, shift2)
        it = it + active.to(torch.int32)
        active = (shift2 > tol) & (it < max_iter)
    # Snap near-integer means to the integer (pure-color clusters), which
    # a downstream uint8 cast would otherwise truncate.
    rounded = torch.round(centers)
    centers = torch.where(torch.abs(centers - rounded) < 1e-3, rounded, centers)
    _, _, inertia = assign_stats(centers)
    return KMeansResult(centers=centers, inertia=inertia)


def _tolerance(flatp: torch.Tensor, flatw: torch.Tensor, k: int) -> torch.Tensor:
    """sklearn's tol = 1e-4 times the mean per-dimension variance of the
    weighted points, times k (it is held against the total shift^2 of the
    centres): (B, N, 3), (B, N) -> (B,)."""
    d = flatp.shape[-1]
    wsum = torch.clamp_min(tree_sum(flatw), 1.0)
    mean = tree_sum((flatp * flatw[..., None]).transpose(1, 2)) / wsum[:, None]
    dev2 = flatp - mean[:, None]
    var = tree_sum((dev2 * dev2 * flatw[..., None]).transpose(1, 2)) \
        / wsum[:, None]
    return 1e-4 * true_div((var[:, 0] + var[:, 1]) + var[:, 2], d) * k


def kmeans_fit_det(points: torch.Tensor, weights: torch.Tensor, k: int, *,
                   max_iter: int = 300, candidates: int = 8) -> KMeansResult:
    """Deterministic, sampling-free k-means for the throughput pipeline.

    points (B, N, 3), weights (B, N) >= 0. Greedy-potential kmeans++
    seeding with deterministic candidates — one at each of `candidates`
    stratified quantiles of the potential CDF cumsum(w * min_d2); the
    winner minimises the total resulting potential — then one Lloyd run.
    The first seed is the heaviest point.
    """
    points = points.to(torch.float32)
    weights = weights.to(torch.float32)
    bsz, _, d = points.shape
    pts, w = _pad_points(points, weights)
    nb, blk = pts.shape[1:3]
    flatp = pts.reshape(bsz, nb * blk, d)
    flatw = w.reshape(bsz, nb * blk)
    dev = points.device

    c0 = _gather_rows(flatp, torch.argmax(flatw, dim=1)[:, None])
    centers = torch.zeros((bsz, k, d), dtype=torch.float32, device=dev)
    centers[:, 0:1] = c0
    min_d2 = _min_d2_blocked(pts, w, c0).reshape(bsz, -1)

    T = candidates
    frac = true_div(torch.arange(T, dtype=torch.float32, device=dev) + 0.5, T)
    for i in range(1, k):
        pot = flatw * min_d2
        cdf = cumsum(pot).contiguous()
        targets = frac[None, :] * cdf[:, -1:]
        cand_idx = torch.clamp(torch.searchsorted(cdf, targets),
                               0, flatp.shape[1] - 1)
        cands = _gather_rows(flatp, cand_idx)             # (B, T, d)
        pots = torch.zeros((bsz, T), dtype=torch.float32, device=dev)
        nds = []
        for j in range(nb):
            pb, wb = pts[:, j], w[:, j]
            md = min_d2.reshape(bsz, nb, blk)[:, j]
            d2 = _pairwise_d2(pb, cands)                  # (B, block, T)
            nd = torch.minimum(d2, md[..., None]) * (wb > 0)[..., None]
            pots = pots + tree_sum((nd * wb[..., None]).transpose(1, 2))
            nds.append(nd)
        nd = torch.cat(nds, dim=1)
        best = torch.argmin(pots, dim=1)                  # (B,)
        centers[:, i] = cands[torch.arange(bsz, device=dev), best]
        min_d2 = torch.gather(nd, 2, best[:, None, None].expand(
            -1, nd.shape[1], 1))[..., 0]

    return _lloyd(pts, w, centers, max_iter, _tolerance(flatp, flatw, k))


# ---------------------------------------------------------------------------
# kmeans_fit: kmeans++ seeding from jax.random's stream, restarts, Lloyd
# ---------------------------------------------------------------------------

# restarts seeded together: bounds the Gumbel draw (restarts, trials, N)
_INIT_ELEMS = 1 << 26


def _d2_points_last(pT: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`_pairwise_d2` with the point axis last: pT (3, n), c (..., 3) ->
    (..., n). The same arithmetic term for term (|x|^2 - 2 x.c + |c|^2,
    the product as three multiply-adds in `_dot3`'s order, written for
    exactly three columns as every caller has colour points), laid out so
    that sums over points run along contiguous memory."""
    if pT.shape[0] != 3 or c.shape[-1] != 3:
        raise ValueError("_d2_points_last takes three-column points")
    c0, c1, c2 = (c[..., j, None] for j in range(3))
    xc = (pT[0] * c0 + pT[1] * c1) + pT[2] * c2
    x2 = (pT[0] * pT[0] + pT[1] * pT[1]) + pT[2] * pT[2]
    cc = (c0 * c0 + c1 * c1) + c2 * c2
    return torch.clamp_min(x2 - 2.0 * xc + cc, 0.0)


def _log_weights(x: torch.Tensor) -> torch.Tensor:
    """log(x) where x > 0, else -inf: the logits of sampling prop. to x."""
    return torch.where(x > 0, torch.log(torch.clamp_min(x, 1e-30)),
                       float("-inf"))


def _kmeanspp_init(keys: Sequence[PRNG.Key], pts: torch.Tensor,
                   w: torch.Tensor, k: int, n_local_trials: int) -> torch.Tensor:
    """Greedy k-means++ over weighted points (sklearn's _kmeans_plusplus)
    for every key at once: pts (nb, block, 3), w (nb, block) ->
    (len(keys), k, 3). Each key draws what the JAX package draws from it:
    the first centre prop. to weight, then `n_local_trials` candidates per
    step prop. to w * min_d2, of which the one with the least total
    potential wins."""
    nb, blk, d = pts.shape
    r = len(keys)
    dev = pts.device
    flatp = pts.reshape(nb * blk, d)
    flatw = w.reshape(nb * blk)
    ptsT = pts.transpose(1, 2).contiguous()                    # (nb, 3, block)
    rows = torch.arange(r, device=dev)

    pairs = [PRNG.split(kk) for kk in keys]
    keys = [pr[0] for pr in pairs]
    idx0 = PRNG.categorical_batched([pr[1] for pr in pairs],
                                    _log_weights(flatw)[None].expand(r, -1))
    centers = torch.zeros((r, k, d), dtype=torch.float32, device=dev)
    centers[:, 0] = flatp[idx0]
    min_d2 = torch.cat([_d2_points_last(ptsT[j], centers[:, 0]) * (w[j] > 0)
                        for j in range(nb)], dim=1)            # (R, N)

    for i in range(1, k):
        pairs = [PRNG.split(kk) for kk in keys]
        keys = [pr[0] for pr in pairs]
        cand_idx = PRNG.categorical_batched(
            [pr[1] for pr in pairs], _log_weights(flatw * min_d2),
            n_local_trials)                                    # (R, T)
        cands = flatp[cand_idx]                                # (R, T, 3)
        # The potential each candidate would leave; the winner's clipped
        # distances are the next min_d2.
        pots = torch.zeros((r, n_local_trials), dtype=torch.float32,
                           device=dev)
        nds = []
        for j in range(nb):
            md = min_d2[:, None, j * blk:(j + 1) * blk]
            nd = torch.minimum(_d2_points_last(ptsT[j], cands), md) \
                * (w[j] > 0)
            pots = pots + tree_sum(nd * w[j])
            nds.append(nd)
        best = torch.argmin(pots, dim=1)                       # (R,)
        centers[:, i] = cands[rows, best]
        min_d2 = torch.cat([nd[rows, best] for nd in nds], dim=1)
    return centers


def _lloyd_restarts(pts, w, centers_all, max_iter: int,
                    tol: torch.Tensor) -> KMeansResult:
    """Weighted Lloyd for every restart in lock step: centers_all
    (R, k, 3). A restart whose shift^2 is within `tol` is frozen (its
    centres are carried unchanged) while the others finish; no restart's
    arithmetic depends on another's, so R = 1 on one restart at a time
    gives the same bits. Returns the restart of least inertia (the first
    on ties)."""
    nb, blk, d = pts.shape
    r, k, _ = centers_all.shape
    dev = pts.device
    ptsT = pts.transpose(1, 2).contiguous()                    # (nb, 3, block)
    bins = torch.arange(k, device=dev)[None, :, None]

    def assign_stats(call):
        sums = torch.zeros((r, k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((r, k), dtype=torch.float32, device=dev)
        inertia = torch.zeros((r,), dtype=torch.float32, device=dev)
        for j in range(nb):
            d2 = _d2_points_last(ptsT[j], call)                # (R, k, block)
            dmin, lbl = torch.min(d2, dim=1)                   # first minimum
            onehot = (lbl[:, None, :] == bins).to(torch.float32) * w[j]
            sums = sums + tree_sum(onehot[:, :, None, :] * ptsT[j])
            counts = counts + tree_sum(onehot)
            inertia = inertia + tree_sum(dmin * w[j])
        return sums, counts, inertia

    def reseed_empty(call, counts):
        """Move empty clusters onto the current farthest points: the i-th
        empty slot takes the i-th farthest point."""
        md = torch.cat([_d2_points_last(ptsT[j], call).amin(dim=1) * (w[j] > 0)
                        for j in range(nb)], dim=1)            # (R, N)
        far_pts = pts.reshape(-1, d)[_top_k_indices(md, k)]    # (R, k, 3)
        empty = counts == 0
        slot = torch.clamp(torch.cumsum(empty.to(torch.int64), dim=1) - 1,
                           0, k - 1)
        return torch.where(empty[..., None], _gather_rows(far_pts, slot), call)

    call = centers_all
    shift2 = torch.full((r,), float("inf"), device=dev)
    moving = bool((shift2 > tol).any())
    it = 0
    while moving and it < max_iter:
        active = shift2 > tol

        def advance(new):
            new = torch.where(active[:, None, None], new, call)
            diff = new - call
            return new, tree_sum((diff * diff).reshape(r, -1))

        sums, counts, _ = assign_stats(call)
        mean = torch.where(counts[..., None] > 0,
                           sums / torch.clamp_min(counts, 1.0)[..., None], call)
        new, new_shift2 = advance(mean)
        # one host read an iteration; the reseed (a sort of every point's
        # distance) runs only when a cluster is empty, where it changes
        # the result
        any_empty, moving = torch.stack(
            [(counts == 0).any(), (new_shift2 > tol).any()]).tolist()
        if any_empty:
            new, new_shift2 = advance(reseed_empty(mean, counts))
            moving = bool((new_shift2 > tol).any())
        call, shift2 = new, new_shift2
        it += 1
    # Snap near-integer means to the integer (pure-colour clusters), which
    # a downstream uint8 cast would otherwise truncate.
    rounded = torch.round(call)
    call = torch.where(torch.abs(call - rounded) < 1e-3, rounded, call)
    _, _, inertia = assign_stats(call)
    best = torch.argmin(inertia)
    return KMeansResult(centers=call[best], inertia=inertia[best])


def kmeans_fit(points: torch.Tensor, weights: torch.Tensor, k: int, *,
               n_init: int = 10, max_iter: int = 300, seed: int = 42,
               batch_restarts: bool | None = None) -> KMeansResult:
    """Fit weighted k-means. points (N, 3) float32, weights (N,) >= 0 ->
    centers (k, 3), inertia ().

    As sklearn's KMeans at the reference's call sites: tol is 1e-4 times
    the mean per-dimension variance of the weighted points, the init is
    greedy kmeans++ with 2 + floor(log(k)) local trials, restart i is
    seeded with fold_in(key(seed), i) and the least inertia wins.

    batch_restarts: None picks the lock-step Lloyd for n_init >= 4 and
    one restart after another below; True and False force either. Both
    give the same result bit for bit.
    """
    points = points.to(torch.float32)
    weights = weights.to(torch.float32)
    ptsb, wb = _pad_points(points[None], weights[None])
    pts, w = ptsb[0], wb[0]
    nb, blk, d = pts.shape
    tol = _tolerance(pts.reshape(1, nb * blk, d), w.reshape(1, nb * blk), k)[0]

    n_local_trials = 2 + int(math.log(max(k, 2)))  # sklearn's heuristic
    key = PRNG.key(seed)
    rkeys = [PRNG.fold_in(key, i) for i in range(n_init)]
    per = max(1, _INIT_ELEMS // (n_local_trials * nb * blk))
    centers0_all = torch.cat(
        [_kmeanspp_init(rkeys[s:s + per], pts, w, k, n_local_trials)
         for s in range(0, n_init, per)], dim=0)

    if batch_restarts is None:
        batch_restarts = n_init >= 4
    if batch_restarts and n_init > 1:
        return _lloyd_restarts(pts, w, centers0_all, max_iter, tol)

    best = KMeansResult(
        centers=torch.zeros((k, d), dtype=torch.float32, device=pts.device),
        inertia=torch.full((), float("inf"), device=pts.device))
    for i in range(n_init):
        res = _lloyd_restarts(pts, w, centers0_all[i:i + 1], max_iter, tol)
        better = res.inertia < best.inertia
        best = KMeansResult(
            centers=torch.where(better, res.centers, best.centers),
            inertia=torch.where(better, res.inertia, best.inertia))
    return best


def assign_labels(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center label per point: (B, N, 3), (B, k, 3) -> (B, N) int64."""
    return torch.argmin(_pairwise_d2(points.to(torch.float32),
                                     centers.to(torch.float32)), dim=2)


def map_to_centers(labels: torch.Tensor, centers_u8: torch.Tensor) -> torch.Tensor:
    """centers_u8[labels] per image: (B, N), (B, k, 3) -> (B, N, 3) uint8."""
    return _gather_rows(centers_u8, labels)
