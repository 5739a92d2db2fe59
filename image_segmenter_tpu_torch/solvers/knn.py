"""Blocked nearest-neighbour search.

Counterpart of image_segmenter_tpu/solvers/knn.py (sklearn's
pairwise_distances_argmin_min / NearestNeighbors(n=1) in the reference's
quantizers). Queries stream through in fixed blocks; each block is one
(block, Nr) distance table and an argmin.
"""

from __future__ import annotations

import torch

_BLOCK = 1 << 14


def sq_norm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis (D = 3), summed in the written order."""
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]


def expanded_d2(q: torch.Tensor, r: torch.Tensor,
                r2: torch.Tensor | None = None) -> torch.Tensor:
    """|q|^2 - 2 q.r + |r|^2 for q (nq, 3) and r (nr, 3) -> (nq, nr). The
    JAX package's form, which decides its radius tests and argmins; the
    product q.r is three elementwise float32 multiply-adds (the full
    float32 precision of its HIGHEST-precision dot, and the same bits on
    every device). Written for exactly three columns: every caller has
    D = 3 colour points."""
    if q.shape[-1] != 3 or r.shape[-1] != 3:
        raise ValueError("expanded_d2 takes three-column points")
    qr = (q[:, None, 0] * r[None, :, 0] + q[:, None, 1] * r[None, :, 1]) \
        + q[:, None, 2] * r[None, :, 2]
    if r2 is None:
        r2 = sq_norm(r)
    return sq_norm(q)[:, None] - 2.0 * qr + r2[None, :]


def nearest_index(queries: torch.Tensor, refs: torch.Tensor,
                  ref_valid: torch.Tensor) -> torch.Tensor:
    """Index of the nearest valid reference point for each query.

    queries (Nq, 3) float32, refs (Nr, 3) float32, ref_valid (Nr,) bool
    -> (Nq,) int64. Ties break to the smallest index.
    """
    q = queries.to(torch.float32)
    r = refs.to(torch.float32)
    r2 = sq_norm(r)
    inf = torch.tensor(float("inf"), device=q.device)
    out = []
    for s in range(0, q.shape[0], _BLOCK):
        d2 = expanded_d2(q[s:s + _BLOCK], r, r2)
        out.append(torch.argmin(torch.where(ref_valid[None, :], d2, inf),
                                dim=1))
    if not out:
        return torch.zeros((0,), dtype=torch.int64, device=q.device)
    return torch.cat(out)
