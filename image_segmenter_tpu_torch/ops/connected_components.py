"""Connected-component labelling by min-label propagation and pointer jumping.

Counterpart of image_segmenter_tpu/ops/connected_components.py (the
reference's cv2.connectedComponentsWithStats and, at 4-connectivity with an
exact colour match, cv2.floodFill).

Labels are linear pixel indices. A component's label is the index of its
first pixel in raster order, which is also its smallest index; a sweep only
ever lowers a label to another index of the same component, so every
propagation that reaches its fixpoint gives these canonical labels, the
JAX package's int32 labels, sizes and bboxes.

A sweep takes the running minimum over each same-colour run of a row and of
a column, in both directions, then the minimum over same-colour diagonal
neighbours (connectivity 8), then follows label <- label[label] four times.
Torch has no segmented scan, so a run's minimum is one cumsum and one
cummax: along the axis, seg = cumsum(not connected to the previous pixel)
numbers the runs, and key = seg * 2^30 + (2^30 - 1 - label) grows with the
run, so within a run cummax(key) is the key of the smallest label so far.
The reverse direction is the same scan on the flipped tensors.

The fixpoint test reads the card once every `SWEEPS_PER_READ` sweeps, not
once a sweep: a sweep past the fixpoint changes nothing, so the labels are
the same bits. `HOST_READS` counts those reads.

Every scatter is an integer `scatter_reduce_` (sum, amin, amax), so the
card's results do not depend on the order of its atomics.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.ops.color import pack_rgb_u32
from image_segmenter_tpu_torch.ops.morphology import shift2d

_JUMPS = 4  # pointer-jumping steps per propagation sweep
_KEY = 1 << 30  # labels and the sentinel stay below it
SWEEPS_PER_READ = 4
HOST_READS = 0

_DIAGONALS = ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _run_min(lbl: torch.Tensor, base: torch.Tensor, dim: int) -> torch.Tensor:
    """Running minimum of lbl within runs along `dim`, base = run id * 2^30."""
    key = base + (_KEY - 1 - lbl)
    return (_KEY - 1) - (torch.cummax(key, dim).values - base)


def _run_bases(conn_prev: torch.Tensor, dim: int):
    """Run ids * 2^30 for the forward scan and for the scan of the flipped
    tensor. conn_prev marks pixels connected to the previous one along
    `dim`; the flipped scan needs connected-to-next, flipped."""
    fwd = torch.cumsum((~conn_prev).to(torch.int64), dim) * _KEY
    conn_next = torch.zeros_like(conn_prev)
    n = conn_prev.shape[dim]
    conn_next.narrow(dim, 0, n - 1).copy_(conn_prev.narrow(dim, 1, n - 1))
    bwd = torch.cumsum((~conn_next.flip(dim)).to(torch.int64), dim) * _KEY
    return fwd, bwd


def _seg_min(lbl, bases, dim):
    fwd, bwd = bases
    a = _run_min(lbl, fwd, dim)
    b = _run_min(lbl.flip(dim), bwd, dim).flip(dim)
    return torch.minimum(a, b)


def label_components(color_id: torch.Tensor, valid: torch.Tensor,
                     connectivity: int = 8) -> torch.Tensor:
    """Label connected same-colour regions.

    Args:
      color_id: (H, W) integer per-pixel colour key.
      valid: (H, W) bool; invalid pixels get label -1.
      connectivity: 4 or 8.

    Returns:
      (H, W) int32 labels; each component's label is the linear index
      (y*W + x) of its first pixel in raster order (its "root"), -1 invalid.
    """
    global HOST_READS
    h, w = color_id.shape
    n = h * w
    if n >= _KEY:
        raise ValueError(f"image of {n} pixels: labels need fewer than 2^30")
    dev = color_id.device
    cid = color_id.to(torch.int64)
    valid = valid.to(torch.bool)
    big = n  # sentinel larger than any label
    lbl = torch.where(valid, torch.arange(n, device=dev).reshape(h, w), big)

    same_left = torch.zeros((h, w), dtype=torch.bool, device=dev)
    same_left[:, 1:] = valid[:, 1:] & valid[:, :-1] & (cid[:, 1:] == cid[:, :-1])
    same_up = torch.zeros((h, w), dtype=torch.bool, device=dev)
    same_up[1:] = valid[1:] & valid[:-1] & (cid[1:] == cid[:-1])
    row_bases = _run_bases(same_left, 1)
    col_bases = _run_bases(same_up, 0)
    diagonals = []
    if connectivity == 8:
        for dy, dx in _DIAGONALS:
            same = valid & shift2d(valid, dy, dx, False) \
                & (shift2d(cid, dy, dx, -1) == cid)
            diagonals.append((dy, dx, same))

    def sweep(lbl):
        best = _seg_min(lbl, row_bases, 1)
        best = _seg_min(best, col_bases, 0)
        for dy, dx, same in diagonals:
            nlbl = shift2d(best, dy, dx, big)
            best = torch.minimum(best, torch.where(same, nlbl, big))
        flat = best.reshape(-1)
        for _ in range(_JUMPS):
            hop = flat[torch.clamp(flat, max=n - 1)]
            flat = torch.where(flat < big, torch.minimum(flat, hop), flat)
        return flat.reshape(h, w)

    while True:
        for _ in range(SWEEPS_PER_READ):
            new = sweep(lbl)
            changed = (new != lbl).any()
            lbl = new
        HOST_READS += 1
        if not bool(changed):
            break
    return torch.where(valid, lbl, -1).to(torch.int32)


def component_stats(color_id: torch.Tensor, valid: torch.Tensor,
                    connectivity: int = 8):
    """Labels and per-root component statistics.

    Returns:
      labels: (H, W) int32 root labels (-1 invalid).
      sizes: (H*W,) int32 — sizes[root] = component pixel count (0 elsewhere).
      bbox: (H*W, 4) int32 — (x_min, y_min, x_max, y_max) per root.
    """
    h, w = color_id.shape
    labels = label_components(color_id, valid, connectivity)
    flat = labels.reshape(-1).to(torch.int64)
    on = flat >= 0
    safe = torch.where(on, flat, 0)
    dev = flat.device
    ys = torch.arange(h, dtype=torch.int32, device=dev).repeat_interleave(w)
    xs = torch.arange(w, dtype=torch.int32, device=dev).repeat(h)
    big = 1 << 30

    def reduce(init, vals, fill, how):
        out = torch.full((h * w,), init, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, safe, torch.where(on, vals, fill), how)

    sizes = reduce(0, on.to(torch.int32), 0, "sum")
    bbox = torch.stack([reduce(big, xs, big, "amin"),
                        reduce(big, ys, big, "amin"),
                        reduce(-1, xs, -1, "amax"),
                        reduce(-1, ys, -1, "amax")], dim=1)
    return labels, sizes, bbox


def flood_fill_component(rgba: torch.Tensor, seed_yx, fill_rgb) -> torch.Tensor:
    """Recolor the 4-connected exact-color component containing the seed.

    Equivalent to the reference's cv.floodFill with loDiff=upDiff=(0,0,0) and
    FLOODFILL_FIXED_RANGE (region_cleanup.py:515-574). cv2.floodFill ignores
    alpha, so transparent pixels of the seed's colour are filled too.
    Transparent seeds and out-of-bounds are handled by the compat wrapper.
    """
    h, w = rgba.shape[:2]
    cid = pack_rgb_u32(rgba[..., :3])
    valid = torch.ones((h, w), dtype=torch.bool, device=rgba.device)
    labels = label_components(cid, valid, connectivity=4)
    mask = labels == labels[seed_yx[0], seed_yx[1]]
    fill = torch.as_tensor(fill_rgb, dtype=torch.uint8, device=rgba.device)
    rgb = torch.where(mask[..., None], fill, rgba[..., :3])
    return torch.cat([rgb, rgba[..., 3:]], dim=-1)
