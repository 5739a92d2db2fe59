"""The entry the window drives for a prompted model: `Pipeline.run(frames,
boxes)` of image_segmenter_tpu_torch, one box a frame.

What a run needs of an entry module is `pipeline_run`'s (see its
docstring); this one reuses its `Entry` and changes what a prompted call
takes and gives:
- `weights(config, devices)`: Segment Anything's state on the card from
  the configuration's weight seed (`yardstick/sam_weights.py`);
- a request is (frames, boxes): a (B, H, W, 3) u8 batch and (B, 4)
  float32 boxes, host numpy (`generators/photo_mosaic_box.py`);
- a call returns rgba, alpha and palettes as `pipeline_run`'s do, and
  the network's low-resolution logits (B, 1, 256, 256) and IoU
  predictions (B, 1), float32, all copied into the client's host
  buffers inside the timed call.

What the benchmark reads of the program besides the outputs:
`pipeline_run`'s launch counters, and the frames and prompts the
network stage ran (`models/sam.FRAMES`, `PROMPTS`).
"""

from __future__ import annotations

import torch

from benchmark.entries import pipeline_run
from benchmark.yardstick.timeline import SPAN_PREFIX

OUTPUTS = ("rgba", "alpha", "palettes", "logits", "iou")


def weights(config: dict, devices: list) -> dict:
    from benchmark.yardstick.sam_weights import make_state

    return make_state(config, config["weight_seed"], devices[0])


class Entry(pipeline_run.Entry):
    def __call__(self, request) -> dict:
        """The outputs of one call as host numpy."""
        frames, boxes = request
        with torch.profiler.record_function(SPAN_PREFIX + "pipeline.run"):
            out = self.pipe.run(frames, boxes)
        with torch.profiler.record_function(SPAN_PREFIX + "outputs.to_host"):
            into = self._free.pop() if self._free else self._buffers(request)
            for k, t in zip(OUTPUTS, (*out, out.logits, out.iou)):
                into[k].copy_(t)
            return {k: into[k].numpy() for k in OUTPUTS} | {"_into": into}

    def _buffers(self, request) -> dict:
        frames, _ = request
        b, h, w = frames.shape[:3]
        g = 4 * self.cfg["widths"]["img_size"] // \
            self.cfg["widths"]["patch_size"]
        shapes = {"rgba": ((b, h, w, 4), torch.uint8),
                  "alpha": ((b, h, w), torch.uint8),
                  "palettes": ((b, self.pipe.k, 3), torch.uint8),
                  "logits": ((b, 1, g, g), torch.float32),
                  "iou": ((b, 1), torch.float32)}
        return {name: torch.empty(shape, dtype=dt,
                                  pin_memory=self.pin).fill_(0)
                for name, (shape, dt) in shapes.items()}

    def work(self, request) -> float:
        """Megapixels of input in a call."""
        return super().work(request[0])

    def counters(self) -> dict:
        """`pipeline_run`'s launches, and the network stage's frames and
        prompts so far in this process."""
        from image_segmenter_tpu_torch.models import sam

        return super().counters() | {"sam_frames": sam.FRAMES,
                                     "sam_prompts": sam.PROMPTS}
