"""Halo exchange for row-split stencil ops.

Counterpart of image_segmenter_tpu/parallel/halo.py. The H axis splits
across the `space` slots of a mesh and a stencil sees `halo` ghost rows
from each neighbour. The JAX package moves them with `lax.ppermute`
inside `shard_map`; here the single controller copies them between the
slots' devices. The matting solve does its own exchange
(solvers/matting.py), because its chain ends must read the image border
rather than zero rows.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from image_segmenter_tpu_torch.parallel.mesh import SPACE_AXIS, Mesh, \
    split_bounds, to_slot


def exchange_rows(blocks: Sequence[torch.Tensor],
                  halo: int) -> List[torch.Tensor]:
    """The row blocks of one space group, in order, each extended with
    `halo` ghost rows from each neighbour and zero rows at the two chain
    ends: block (H_j, ...) -> (H_j + 2 * halo, ...) on its own device.
    Raises ValueError when a block has fewer rows than `halo`."""
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    for j, x in enumerate(blocks):
        if x.shape[0] < halo:
            raise ValueError(f"block {j} has {x.shape[0]} rows, fewer than "
                             f"the halo of {halo}")
    if halo == 0:
        return list(blocks)
    out = []
    n = len(blocks)
    for j, x in enumerate(blocks):
        zeros = x.new_zeros((halo, *x.shape[1:]))
        upper = to_slot(blocks[j - 1][-halo:], x.device) if j > 0 else zeros
        lower = to_slot(blocks[j + 1][:halo], x.device) if j < n - 1 else zeros
        out.append(torch.cat([upper, x, lower]))
    return out


def sharded_stencil(fn: Callable, halo: int, mesh: Mesh,
                    axis_name: str = SPACE_AXIS) -> Callable:
    """Wrap a per-block stencil fn((H_j + 2 * halo, W[, C])) -> same rows
    into a row-split whole-image op on (H, W[, C]).

    fn must be shift-invariant with a footprint <= halo; its output's ghost
    rows are dropped. The rows split over the slots of `axis_name` at
    index 0 of the mesh's other axes (which would hold replicas), and the
    result is gathered on the first of them."""
    ax = mesh.axis_names.index(axis_name)
    slots = list(np.moveaxis(mesh.devices, ax, 0)
                 .reshape(mesh.shape[ax], -1)[:, 0])

    def run(x: torch.Tensor) -> torch.Tensor:
        blocks = [to_slot(x[b0:b1], dev) for (b0, b1), dev
                  in zip(split_bounds(x.shape[0], len(slots)), slots)]
        outs = [fn(e)[halo:e.shape[0] - halo]
                for e in exchange_rows(blocks, halo)]
        return torch.cat([to_slot(o, slots[0]) for o in outs])

    return run
