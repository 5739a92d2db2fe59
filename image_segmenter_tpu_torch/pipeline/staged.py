"""Pipeline parallelism: the three phases staged across mesh sub-groups.

Counterpart of image_segmenter_tpu/pipeline/staged.py (BASELINE config 5's
staging of rembg -> matting -> quantize for streaming throughput):

- each phase runs on its own sub-mesh of device slots, data-parallel over
  the batch within it (every image on one slot per stage, so no sum
  inside an image crosses slots);
- activations hop between the sub-meshes with `.to(..., non_blocking=
  True)` copies, queued on the card's stream;
- the host feeds micro-batches in a plain loop and yields the outputs in
  the order the batches came in.

The stages are the fused `Pipeline`'s (`make_stage_fns`), so a staged run
gives each image what the fused run gives it at the same batch split.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.models import registry as REG
from image_segmenter_tpu_torch.parallel.mesh import Mesh, device_grid, \
    split_bounds, take, to_slot
from image_segmenter_tpu_torch.pipeline.segment import PipelineOutput, \
    make_stage_fns, network_on
from image_segmenter_tpu_torch.utils.backend import resolve_device

_STAGE_AXIS = "data"


def split_stage_meshes(devices: Optional[Sequence] = None,
                       fractions: Sequence[int] = (2, 1, 1)):
    """Partition a list of device slots into 3 stage sub-meshes sized by
    `fractions` (by default every CUDA device).

    Default (2, 1, 1): half the slots on the CNN, a quarter each on
    matting and quantize, the JAX package's split. Raises ValueError
    below 3 slots."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("split_stage_meshes: no CUDA device, and no "
                               "devices were given")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    total = sum(fractions)
    n = len(devices)
    if n < 3:
        raise ValueError(f"pipeline parallelism needs >= 3 devices, have {n}")
    sizes = [max(1, (n * f) // total) for f in fractions]
    while sum(sizes) > n:
        sizes[int(np.argmax(sizes))] -= 1
    while sum(sizes) < n:
        sizes[int(np.argmin(sizes))] += 1
    meshes = []
    off = 0
    for s in sizes:
        meshes.append(Mesh(device_grid(devices[off:off + s], (s,)),
                           (_STAGE_AXIS,)))
        off += s
    return tuple(meshes)


class StagedPipeline:
    """Streaming pipeline with each phase on its own sub-group of slots.

    The outputs are gathered on `device` (by default the first slot of
    the quantize mesh)."""

    def __init__(self, model: str = "u2netp", k: int = 16,
                 matting_dim: Optional[int] = None, cg_iters: int = 200,
                 meshes=None, device=None):
        if model in REG.SPECS and REG.SPECS[model].prompted:
            raise ValueError(f"{model} takes a box a frame; the staged run "
                             "has no prompts: use Pipeline.run(imgs, boxes)")
        self.meshes = tuple(meshes) if meshes is not None \
            else split_stage_meshes()
        if len(self.meshes) != 3:
            raise ValueError("need exactly 3 stage meshes (cnn, matting, "
                             "quantize)")
        self.slots = [[resolve_device(d) for d in m.devices.flat]
                      for m in self.meshes]
        self.device = self.slots[2][0] if device is None \
            else resolve_device(device)
        self.session = REG.new_session(model, device=self.slots[0][0])
        self.k = k
        self.matting_dim = matting_dim or DEFAULTS.matting_max_dim
        self.cg_iters = cg_iters
        self._stages = {}
        self._copies = {}

    def _on(self, dev: torch.device):
        """(stage functions, network) on `dev`; the functions made once
        per device."""
        key = str(dev)
        if key not in self._stages:
            self._stages[key] = make_stage_fns(
                self.session, self.k, self.matting_dim, self.cg_iters,
                device=dev)
        return self._stages[key], network_on(self.session.module, dev,
                                             self._copies)

    def run(self, imgs_u8) -> PipelineOutput:
        """One micro-batch through all three stages."""
        return next(iter(self.run_stream([imgs_u8])))

    def run_stream(self, batches: Iterable) -> Iterator[PipelineOutput]:
        """Stream micro-batches through the stages; outputs come out in the
        order the batches went in."""
        for imgs in batches:
            x = torch.as_tensor(imgs)
            if x.dim() != 4 or x.shape[-1] != 3 or x.dtype != torch.uint8:
                raise ValueError("StagedPipeline takes (B, H, W, 3) uint8 "
                                 f"batches, got {tuple(x.shape)} {x.dtype}")
            b = x.shape[0]
            # each stage: the batch split over its slots (empty pieces
            # dropped), inputs taken from the previous stage's pieces
            cuts = [[(lo, hi) for lo, hi in split_bounds(b, len(s)) if hi > lo]
                    for s in self.slots]
            devs = [s[:len(c)] for s, c in zip(self.slots, cuts)]

            x1, masks = [], []
            for (lo, hi), d in zip(cuts[0], devs[0]):
                st, net = self._on(d)
                x1.append(to_slot(x[lo:hi], d))
                masks.append(st.cnn(net, x1[-1]))

            x2, sharp, alpha = [], [], []
            for (lo, hi), d in zip(cuts[1], devs[1]):
                x2.append(take(x1, cuts[0], lo, hi, d))
                s, a = self._on(d)[0].matting(
                    x2[-1], take(masks, cuts[0], lo, hi, d))
                sharp.append(s)
                alpha.append(a)

            quant = [self._on(d)[0].quantize(take(x2, cuts[1], lo, hi, d),
                                             take(sharp, cuts[1], lo, hi, d))
                     for (lo, hi), d in zip(cuts[2], devs[2])]
            yield PipelineOutput(
                torch.cat([to_slot(r, self.device) for r, _ in quant]),
                take(alpha, cuts[1], 0, b, self.device),
                torch.cat([to_slot(p, self.device) for _, p in quant]))

