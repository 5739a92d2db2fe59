"""Exact Ward agglomerative clustering via parallel reciprocal-NN rounds.

Counterpart of image_segmenter_tpu/solvers/agglomerative.py (sklearn's
AgglomerativeClustering(linkage="ward") in the reference's perceptual
quantizer).

Ward linkage is reducible, so merging every reciprocal nearest-neighbour
pair at once yields the same dendrogram as the sequential NN-chain. Each
round computes every active cluster's Ward nearest neighbour,
d(A, B) = |A||B| / (|A| + |B|) * ||muA - muB||^2, as a chunked dense
distance sweep, and merges all pairs with nn[nn[i]] == i. The distances
are elementwise differences over D = 3 in the written order, never a
matrix product: exact distances decide the merge order.

The rounds emit merges in discovery order, not height order, so the cut
at k clusters sorts the recorded merges by height (a stable sort) and
applies the n - k smallest as unions. The JAX package runs those up to N
sequential unions on the device; here they run on the host over the
recorded (i, j, height) triples with a union-find that keeps each
component's least index as its label, which is what relabelling the
larger label to the smaller one at every union arrives at. One transfer
of three (N,) arrays replaces tens of thousands of small launches.
"""

from __future__ import annotations

import numpy as np
import torch

_CHUNK = 1024  # rows per distance-sweep block (_CHUNK x N live at once)


def _nn_active(cent: torch.Tensor, sz: torch.Tensor):
    """Ward nearest neighbour (index, distance) among the rows given, all
    of them active clusters: cent (m, 3), sz (m,). Chunked over rows."""
    m, d = cent.shape
    inf = torch.tensor(float("inf"), device=cent.device)
    cols = torch.arange(m, device=cent.device)
    nn, dmin = [], []
    for i0 in range(0, m, _CHUNK):
        cb, szb = cent[i0:i0 + _CHUNK], sz[i0:i0 + _CHUNK]
        d2 = torch.zeros((cb.shape[0], m), dtype=torch.float32,
                         device=cent.device)
        for c in range(d):
            diff = cb[:, None, c] - cent[None, :, c]
            d2 = d2 + diff * diff
        wgt = szb[:, None] * sz[None, :] / torch.clamp_min(
            szb[:, None] + sz[None, :], 1e-30)
        dist = torch.where(cols[i0:i0 + _CHUNK, None] != cols[None, :],
                           wgt * d2, inf)
        dm, j = torch.min(dist, dim=1)  # the first minimum
        nn.append(j)
        dmin.append(dm)
    return torch.cat(nn), torch.cat(dmin)


def _cut(mi: np.ndarray, mj: np.ndarray, mh: np.ndarray, n: int,
         n_apply: int) -> np.ndarray:
    """Apply the `n_apply` lowest merges as unions; every point's label is
    the least index of its component."""
    order = np.argsort(mh, kind="stable")  # unused slots are inf: sorted last
    parent = list(range(n))

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for t in range(min(n_apply, n)):
        m = order[t]
        a, b = find(int(mi[m])), find(int(mj[m]))
        if a != b:
            parent[max(a, b)] = min(a, b)
    return np.fromiter((find(a) for a in range(n)), dtype=np.int64, count=n)


def ward_labels(points: torch.Tensor, n_valid: int, k: int) -> torch.Tensor:
    """Cluster points[:n_valid] into k clusters with exact Ward linkage.

    points (N, 3) float32 (rows >= n_valid are padding), n_valid the number
    of real points (callers guard n_valid >= k) -> (N,) int64 labels in
    [0, k); padding rows get label 0. Labels are numbered by ascending
    least member index: compare as partitions.
    """
    n = points.shape[0]
    n_valid = int(n_valid)
    dev = points.device
    idx = torch.arange(n, device=dev)
    active0 = idx < n_valid

    # Phase 1: reciprocal-NN rounds, recording all n_valid - 1 merges.
    # The JAX package sweeps all N rows every round with the absorbed ones
    # masked; here a round gathers the active rows (in index order, so
    # ties still go to the lowest index) and sweeps only those, the same
    # arithmetic on the rows that matter.
    cent = points.to(torch.float32).clone()
    sz = active0.to(torch.float32)
    alive = idx[:n_valid]                                  # active rows
    mi = torch.zeros((n,), dtype=torch.int64, device=dev)  # kept index
    mj = torch.zeros((n,), dtype=torch.int64, device=dev)  # absorbed index
    mh = torch.full((n,), float("inf"), device=dev)        # merge height
    mcount = 0
    while alive.shape[0] > 1:
        nn, dmin = _nn_active(cent[alive], sz[alive])
        local = torch.arange(alive.shape[0], device=dev)
        mutual = nn[nn] == local
        recip = mutual & (local < nn)     # each pair counted once, at its min
        absorbed = mutual & (local > nn)  # ... and absorbed at its max

        # Record the merges in discovery order (the round's one host read:
        # the number of pairs).
        keep, part = alive[recip], alive[nn[recip]]
        n_merges = int(keep.shape[0])
        if n_merges == 0:
            break  # only non-finite distances are left
        slot = slice(mcount, mcount + n_merges)
        mi[slot], mj[slot], mh[slot] = keep, part, dmin[recip]
        mcount += n_merges

        # Apply all merges at once: the keeper absorbs its partner.
        tot = sz[keep] + sz[part]
        cent[keep] = (cent[keep] * sz[keep][:, None]
                      + cent[part] * sz[part][:, None]) \
            / torch.clamp_min(tot, 1e-30)[:, None]
        sz[keep] = tot
        sz[part] = 0.0
        alive = alive[~absorbed]

    # Phase 2: cut, on the host
    asg = _cut(mi.cpu().numpy(), mj.cpu().numpy(), mh.cpu().numpy(), n,
               max(n_valid - k, 0))
    is_rep = (asg == np.arange(n)) & (np.arange(n) < n_valid)
    rep_rank = np.cumsum(is_rep.astype(np.int64)) - 1
    labels = np.clip(rep_rank[asg], 0, k - 1)
    return torch.from_numpy(labels).to(dev)
