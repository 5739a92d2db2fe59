"""4-neighbor majority-vote recoloring step (harness smoother).

Counterpart of image_segmenter_tpu/kernels/majority.py (lax code, not a
Pallas kernel). Reference: app/test_smoothing_algorithms.py:1066-1106 — for
every interior non-transparent pixel, if >= 3 of its 4 opaque neighbors
share a color, adopt it. One step is a shift stencil on the input's device.

The reference counts a pixel as "changed" whenever the rule fires, even if
the adopted color equals the current one (:1104-1107), so its loop never
converges by "no changes" on stable majority pixels and exits through
oscillation detection instead. `applied` reproduces that count; `differs`
counts real changes.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.ops.morphology import shift2d


def majority_step(cid: torch.Tensor, opaque: torch.Tensor):
    """One majority-vote pass.

    Args:
      cid: (H, W) integer packed colors.
      opaque: (H, W) bool.

    Returns:
      (new_cid, applied, differs): applied = pixels where the rule fired
      (reference's pixels_changed), differs = pixels whose color actually
      changed; both 0-d tensors.
    """
    h, w = cid.shape
    nbs = [(shift2d(cid, dy, dx, 0), shift2d(opaque, dy, dx, False))
           for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))]

    # count matches for each neighbor's color among valid neighbors
    best_color = cid
    best_count = torch.zeros((h, w), dtype=torch.int32, device=cid.device)
    for ci, vi in nbs:
        cnt = torch.zeros((h, w), dtype=torch.int32, device=cid.device)
        for cj, vj in nbs:
            cnt = cnt + (vi & vj & (ci == cj)).to(torch.int32)
        better = vi & (cnt > best_count)
        best_color = torch.where(better, ci, best_color)
        best_count = torch.where(better, cnt, best_count)

    interior = torch.zeros((h, w), dtype=torch.bool, device=cid.device)
    interior[1:h - 1, 1:w - 1] = True
    fire = interior & opaque & (best_count >= 3)
    new_cid = torch.where(fire, best_color, cid)
    return new_cid, fire.sum(), (fire & (best_color != cid)).sum()
