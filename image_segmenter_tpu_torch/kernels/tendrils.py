"""Tendril trimming as segmented scans (reference tendril_trimming.py).

Counterpart of image_segmenter_tpu/kernels/tendrils.py, which is lax code,
not a Pallas kernel: the same algorithm as torch ops on the input's device.

The reference marks a pixel as a tendril when its horizontal OR vertical
same-color run length is <= threshold, then recolors scan-line runs of
marked pixels to the run's majority color (long runs) or an adjacent normal
color (short runs), iterating to a fixpoint (<= 30 iterations).

- Run extents come from `torch.cummax` prefix scans: a boundary flag turns
  position into "last boundary at or before me" (run start); the mirrored
  scan gives run end.
- Majority colour per marked run: two stable argsorts group (segment,
  colour) pairs; integer scatters give per-group counts and first
  positions, and a scatter-max of a packed (count, -first position) key
  picks the reference's majority with its first-seen tie-break.
- Alpha sentinels (NORMAL=10, H_THIN=11, V_THIN=12, BOTH=13) and the
  horizontal-then-vertical pass order are kept bit for bit.

Packed colours are the port's int64 `pack_rgb_u32` keys. Both loops read
the card once every `ITERS_PER_READ` iterations rather than every one: an
iteration past the stop changes nothing, and the trim loop never runs more
iterations after a read than `max_iterations` leaves, so the results and
the iteration count are the JAX loop's.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.ops.color import pack_rgb_u32, unpack_rgb_u32
from image_segmenter_tpu_torch.ops.morphology import shift2d

NORMAL = 10
H_THIN = 11
V_THIN = 12
BOTH_THIN = 13
ITERS_PER_READ = 4

_W2 = 1 << 13  # > max run length (W <= 8192 supported)


def _bounds(left_same: torch.Tensor, right_same: torch.Tensor):
    """Run [start, end] per pixel along axis 1 from connected-to-left and
    connected-to-right flags."""
    h, w = left_same.shape
    xs = torch.arange(w, dtype=torch.int32, device=left_same.device)[None, :]
    start = torch.cummax(torch.where(left_same, -1, xs), 1).values
    neg = torch.where(right_same, -w, -xs).flip(1)
    end = -torch.cummax(neg, 1).values.flip(1)
    return start, end


def _run_extents(cid: torch.Tensor, opaque: torch.Tensor):
    """Per-pixel same-color run [start, end] along axis 1 (rows).

    A run breaks at transparency or color change. Returns (start, end) int32
    tensors shaped like cid; meaningless at transparent pixels.
    """
    h, w = cid.shape
    same = (cid[:, 1:] == cid[:, :-1]) & opaque[:, 1:] & opaque[:, :-1]
    f = torch.zeros((h, 1), dtype=torch.bool, device=cid.device)
    return _bounds(torch.cat([f, same], 1), torch.cat([same, f], 1))


def _mark(rgb_cid: torch.Tensor, opaque: torch.Tensor, threshold):
    """Alpha sentinel plane + tendril count (reference _mark_tendrils)."""
    s, e = _run_extents(rgb_cid, opaque)
    h_thick = e - s + 1
    sT, eT = _run_extents(rgb_cid.T, opaque.T)
    v_thick = (eT - sT + 1).T
    h_thin = opaque & (h_thick <= threshold)
    v_thin = opaque & (v_thick <= threshold)
    alpha = torch.where(
        opaque,
        torch.where(h_thin & v_thin, BOTH_THIN,
                    torch.where(h_thin, H_THIN,
                                torch.where(v_thin, V_THIN, NORMAL))),
        0,
    ).to(torch.uint8)
    count = (h_thin | v_thin).sum()
    return alpha, count


def _majority_per_run(marked: torch.Tensor, cid: torch.Tensor):
    """Majority color of each horizontal run of marked pixels.

    Returns (seg_start, seg_end, majority_cid) per pixel (valid at marked
    pixels). Tie-break: highest count, then first occurrence scanning the run
    (reference :286-290).
    """
    h, w = marked.shape
    dev = marked.device
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    both = marked[:, 1:] & marked[:, :-1]
    f = torch.zeros((h, 1), dtype=torch.bool, device=dev)
    start, end = _bounds(torch.cat([f, both], 1), torch.cat([both, f], 1))

    rows = torch.arange(h, dtype=torch.int64, device=dev)[:, None]
    hw = h * w
    seg_all = (rows * w + start).reshape(-1)       # unique segment id
    seg = torch.where(marked.reshape(-1), seg_all, hw)  # unmarked -> dump slot
    colr = cid.reshape(-1)
    xoff = (xs - start).reshape(-1)                 # position within run

    # Group identical (seg, color): stable sort by color then by seg.
    o1 = torch.argsort(colr, stable=True)
    seg1, col1, x1 = seg[o1], colr[o1], xoff[o1]
    o2 = torch.argsort(seg1, stable=True)
    seg2, col2, x2 = seg1[o2], col1[o2], x1[o2]

    new_group = torch.ones(hw, dtype=torch.bool, device=dev)
    new_group[1:] = (seg2[1:] != seg2[:-1]) | (col2[1:] != col2[:-1])
    gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
    real = seg2 < hw
    counts = torch.zeros(hw + 1, dtype=torch.int32, device=dev).scatter_reduce_(
        0, gid, real.to(torch.int32), "sum")
    first_x = torch.full((hw + 1,), 1 << 20, dtype=torch.int32,
                         device=dev).scatter_reduce_(
        0, gid, torch.where(real, x2, 1 << 20), "amin")

    # Packed preference key: count major, earlier-first tie-break minor.
    key = counts[gid] * _W2 + (_W2 - 1 - torch.clamp(first_x[gid], max=_W2 - 1))
    best_key = torch.zeros(hw + 1, dtype=torch.int32, device=dev) \
        .scatter_reduce_(0, seg2, key, "amax")
    is_best = key == best_key[seg2]
    maj = torch.zeros(hw + 1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg2, torch.where(is_best, col2, 0), "amax")

    maj_px = maj[torch.where(marked.reshape(-1), seg_all, hw)]
    return start, end, maj_px.reshape(h, w)


def _adjacent_normal_color(cid: torch.Tensor, alpha: torch.Tensor):
    """First NORMAL 4-neighbor's color in up/down/left/right order
    (reference _find_adjacent_color :318-337). Returns (color, found)."""
    color = torch.zeros_like(cid)
    found = torch.zeros(cid.shape, dtype=torch.bool, device=cid.device)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        n_normal = shift2d(alpha, dy, dx, 0) == NORMAL
        color = torch.where(n_normal & ~found, shift2d(cid, dy, dx, 0), color)
        found = found | n_normal
    return color, found


def _process_axis(cid: torch.Tensor, alpha: torch.Tensor, threshold,
                  horizontal: bool):
    """One directional pass (reference _process_{horizontal,vertical}_tendrils)."""
    if horizontal:
        m = (alpha == H_THIN) | (alpha == BOTH_THIN)
        c, a = cid, alpha
    else:
        m = (alpha == V_THIN).T
        c, a = cid.T, alpha.T

    start, end, maj = _majority_per_run(m, c)
    long_run = (end - start + 1) > threshold

    adj_color, adj_found = _adjacent_normal_color(cid, alpha)
    if not horizontal:
        adj_color, adj_found = adj_color.T, adj_found.T

    new_c = torch.where(m & long_run, maj,
                        torch.where(m & adj_found, adj_color, c))
    changed = m & (long_run | adj_found)
    new_a = torch.where(changed, NORMAL, a).to(torch.uint8)
    if not horizontal:
        new_c, new_a = new_c.T, new_a.T
    return new_c.contiguous(), new_a.contiguous()


def _process(cid, alpha, threshold):
    cid, alpha = _process_axis(cid, alpha, threshold, True)
    return _process_axis(cid, alpha, threshold, False)


def trim_tendrils_core(rgba: torch.Tensor, threshold, max_iterations):
    """Full trim loop. Returns (rgba_out, iterations_used) with the count a
    Python int.

    An iteration marks, and processes when it marked anything. Processing
    nothing marked is the identity and marks nothing next time, so the loop
    runs the processing unconditionally, counts an iteration where the mark
    count is positive, and reads (count, iterations) from the card once a
    chunk: at most min(ITERS_PER_READ, max_iterations - iterations) a chunk,
    so it never passes max_iterations.
    """
    threshold = int(threshold)
    max_iterations = int(max_iterations)
    opaque0 = rgba[..., 3] > 0
    cid = pack_rgb_u32(rgba[..., :3])
    it = 0
    it_d = torch.zeros((), dtype=torch.int64, device=rgba.device)
    while it < max_iterations:
        for _ in range(min(ITERS_PER_READ, max_iterations - it)):
            alpha, count = _mark(cid, opaque0, threshold)
            cid, _ = _process(cid, alpha, threshold)
            it_d = it_d + (count > 0)
        last, it = torch.stack([count, it_d]).tolist()
        if last == 0:
            break
    rgb = unpack_rgb_u32(cid)
    alpha_out = torch.where(opaque0, 255, rgba[..., 3]).to(torch.uint8)
    return torch.cat([rgb, alpha_out[..., None]], dim=-1), it


def mark_tendrils_core(rgba: torch.Tensor, threshold):
    """One marking pass on the current image: returns (alpha_plane, count)."""
    opaque = rgba[..., 3] > 0
    return _mark(pack_rgb_u32(rgba[..., :3]), opaque, int(threshold))


def process_tendrils_core(rgba_rgb_cid: torch.Tensor, alpha: torch.Tensor,
                          threshold):
    """Horizontal + vertical processing of pre-marked sentinels."""
    return _process(rgba_rgb_cid, alpha, int(threshold))


def magenta_cleanup_core(cid: torch.Tensor, alpha: torch.Tensor):
    """Recolor any remaining marked pixels from an adjacent NORMAL color,
    gray fallback (reference _apply_color_selection_to_magenta :362-389).

    As in the JAX package, marked pixels resolve together, round after
    round, until a round resolves none; the card is read once every
    ITERS_PER_READ rounds (a round that resolves none is the identity).
    Returns (cid, alpha, n0) with n0 the marked count before, a 0-d tensor.
    """
    def marked_of(a):
        return (a == H_THIN) | (a == V_THIN) | (a == BOTH_THIN)

    n0 = marked_of(alpha).sum()
    a = alpha
    while True:
        for _ in range(ITERS_PER_READ):
            marked = marked_of(a)
            color, found = _adjacent_normal_color(cid, a)
            fix = marked & found
            cid = torch.where(fix, color, cid)
            a = torch.where(fix, NORMAL, a).to(torch.uint8)
        if not bool(fix.any()):
            break
    # leftovers (no NORMAL reachable) -> gray 128
    marked = marked_of(a)
    gray = (128 << 16) | (128 << 8) | 128
    cid = torch.where(marked, gray, cid)
    a = torch.where(marked, NORMAL, a).to(torch.uint8)
    return cid, a, n0
