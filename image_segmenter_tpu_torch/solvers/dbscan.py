"""DBSCAN over weighted (deduplicated) points, as blocked distance sweeps.

Counterpart of image_segmenter_tpu/solvers/dbscan.py (sklearn's
DBSCAN(eps, min_samples) in the reference's adaptive_distance quantizer).

The input is discrete colours, so it deduplicates to unique points with
multiplicities. A point's eps-neighbour count is the count-weighted sum
over the unique points within eps (sklearn counts the point itself, and
duplicates are distance-0 neighbours: multiplicities handle both). Core
points cluster by connected components of the eps-graph, computed by
min-label propagation: label(i) <- min label of its core neighbours, with
four pointer-doubling jumps between sweeps, until nothing changes (one
host read a sweep). Every sweep is a blocked (block, N) distance table:
no neighbour lists, no unions.

Border (non-core) points join the cluster of their nearest core point
within eps; points with none are noise (-1), as in sklearn.

The distances keep the JAX package's form |x|^2 - 2 x.y + |y|^2 with an
elementwise product (solvers/knn.expanded_d2): that form decides
d2 <= eps^2.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.solvers.knn import expanded_d2, sq_norm

_BLOCK = 2048


def dbscan_labels(points: torch.Tensor, counts: torch.Tensor,
                  valid: torch.Tensor, eps: float,
                  min_samples: float) -> torch.Tensor:
    """DBSCAN labels for unique points with multiplicities.

    points (N, 3) float32 (padded rows arbitrary), counts (N,) float32
    multiplicities (0 for padding), valid (N,) bool, eps the radius,
    min_samples the core threshold (the point itself and multiplicities
    included) -> (N,) int64 labels: >= 0 cluster id (the least index of the
    cluster's core set), -1 noise, -2 padding.
    """
    # Padding takes no part: the sweeps run over the valid rows alone (in
    # index order), and their labels are mapped back to row indices.
    keep = torch.nonzero(valid)[:, 0]
    local = _dbscan_valid(points.to(torch.float32)[keep],
                          counts.to(torch.float32)[keep], eps, min_samples)
    out = torch.full((points.shape[0],), -2, dtype=torch.int64,
                     device=points.device)
    out[keep] = torch.where(local >= 0, keep[torch.clamp_min(local, 0)], local)
    return out


def _dbscan_valid(pts: torch.Tensor, cnt: torch.Tensor, eps: float,
                  min_samples: float) -> torch.Tensor:
    """DBSCAN over rows that are all valid: labels >= 0 (the least row of
    the cluster's core set) or -1 (noise)."""
    n = pts.shape[0]
    dev = pts.device
    f32 = torch.float32
    eps2 = torch.tensor(eps, dtype=f32, device=dev) ** 2
    min_samples = torch.tensor(min_samples, dtype=f32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    p2 = sq_norm(pts)

    def blocks():
        for s in range(0, n, _BLOCK):
            yield expanded_d2(pts[s:s + _BLOCK], pts, p2)

    def min_over_neighbors(values):
        """For each point the least of `values` among its eps-neighbours."""
        return torch.cat([
            torch.where(d2 <= eps2, values[None, :], inf)
            .amin(dim=1) for d2 in blocks()])

    # Core points: weighted neighbour mass >= min_samples.
    wsum = torch.cat([
        torch.where(d2 <= eps2, cnt[None, :], zero)
        .sum(dim=1) for d2 in blocks()])
    core = wsum >= min_samples

    # Min-label propagation among core points.
    lbl = torch.where(core, torch.arange(n, dtype=f32, device=dev), inf)
    changed = True
    while changed:
        vmin = min_over_neighbors(torch.where(core, lbl, inf))
        new = torch.where(core, torch.minimum(lbl, vmin), lbl)
        # Pointer doubling: a core point's label is the index of another
        # core point, so lbl[lbl] chases toward the component's least index
        # at the cost of a gather; the same fixpoint in far fewer sweeps.
        for _ in range(4):
            finite = torch.isfinite(new)
            chased = torch.where(
                finite, new[torch.where(finite, new, zero).to(torch.int64)],
                inf)
            new = torch.where(core, torch.minimum(new, chased), new)
        changed = bool((new != lbl).any())
        lbl = new

    # Border points: the nearest core neighbour's label within eps.
    border = []
    for d2 in blocks():
        d2 = torch.where(core[None, :], d2, inf)
        m, j = torch.min(d2, dim=1)
        border.append(torch.where(m <= eps2, lbl[j], -1.0))
    out = torch.where(core, lbl, torch.cat(border))
    out = torch.where(torch.isinf(out), -1.0, out)
    return out.to(torch.int64)
