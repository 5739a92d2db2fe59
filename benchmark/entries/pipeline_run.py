"""The entry the window drives: `Pipeline.run` of image_segmenter_tpu_torch.

What a run needs of an entry module (`benchmark/run.py` reads nothing
else of it):
- `weights(config, devices)`: what the benchmark makes for both sides,
  here the network's weights, on the card from the configuration's weight
  seed (`yardstick/weights.py`); handed to the entry and the reference;
- `Entry(config, traffic, state, devices)`: the system under test;
  `entry(request)` makes one call and returns its outputs;
  `entry.release(outputs)` hands back outputs the harness no longer
  keeps; `warm_up(requests)`, `work(request)` (megapixels of input),
  `counters()`, `record()`, `call_info()` and `close()`.

`Entry` builds the port's library of kernels (`kernels/_build.library`,
cached in the checkout's `image_segmenter_tpu_torch/kernels/_build/`),
makes `Pipeline(model=config["model"], k, matting_dim, cg_iters)` on the
first device and loads the benchmark's weights into its session. A call
takes a (B, H, W, 3) u8 batch as host numpy and returns the user's
outputs as host numpy: rgba (B, H, W, 4), alpha (B, H, W) and palettes
(B, k, 3). On the card `Pipeline.run` captures its CUDA graphs at the
first call of a shape and replays them after.

The client receives the outputs into host buffers it made once and
reuses, of the traffic's `host_memory`: page locked on a card for
"page_locked" (a streaming client's pinned buffers), plain pageable
memory for "pageable" (numpy arrays a plain client keeps).

What the benchmark reads of the program besides the outputs: the launch
counters of the main path's kernels (K1 histogram, K2 precompute, K3
matvec, K4 quantize) and each loop's iterations in the last call.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.yardstick import flops
from benchmark.yardstick.timeline import SPAN_PREFIX

OUTPUTS = ("rgba", "alpha", "palettes")


def weights(config: dict, devices: list) -> dict:
    from benchmark.yardstick.weights import make_state

    return make_state(config["arch"], config["weight_seed"], devices[0])


class Entry:
    def __init__(self, config: dict, traffic: dict, state: dict,
                 devices: list):
        from image_segmenter_tpu_torch.kernels import histogram, matvec, \
            precompute, quantize
        from image_segmenter_tpu_torch.pipeline.segment import Pipeline

        self.cfg, self.traffic = config, traffic
        self.device = torch.device(devices[0])
        if self.device.type == "cuda":
            from image_segmenter_tpu_torch.kernels import _build

            _build.library()
        self._kernels = {"histogram": histogram, "precompute": precompute,
                         "matvec": matvec, "quantize": quantize}
        self.pipe = Pipeline(model=config["model"], k=config["k"],
                             matting_dim=config["matting_dim"],
                             cg_iters=config["cg_iters"], device=self.device)
        self.pipe.session.load_state_dict(state)
        self.pin = self.device.type == "cuda" and \
            traffic["host_memory"] == "page_locked"
        self._free = []

    def __call__(self, batch: np.ndarray) -> dict:
        """The outputs of one call as host numpy."""
        with torch.profiler.record_function(SPAN_PREFIX + "pipeline.run"):
            out = self.pipe.run(batch)
        with torch.profiler.record_function(SPAN_PREFIX + "outputs.to_host"):
            into = self._free.pop() if self._free else self._buffers(batch)
            for k, t in zip(OUTPUTS, out):
                into[k].copy_(t)
            return {k: into[k].numpy() for k in OUTPUTS} | {"_into": into}

    def release(self, outputs: dict) -> None:
        """Take back the buffers of outputs the harness no longer keeps
        (outputs made elsewhere, such as the control's, hold none)."""
        if "_into" in outputs:
            self._free.append(outputs["_into"])

    def _buffers(self, batch: np.ndarray) -> dict:
        b, h, w = batch.shape[:3]
        shapes = {"rgba": (b, h, w, 4), "alpha": (b, h, w),
                  "palettes": (b, self.pipe.k, 3)}
        return {name: torch.empty(shapes[name], dtype=torch.uint8,
                                  pin_memory=self.pin).fill_(0)
                for name in OUTPUTS}

    def warm_up(self, requests: list) -> None:
        """The client's receive buffers, one a kept call and one to fill,
        each written once; then the shape's capture and a replay."""
        self._free += [self._buffers(requests[0])
                       for _ in range(self.traffic["check_calls"] + 1)]
        for b in requests[-2:]:
            self.release(self(b))

    def work(self, batch: np.ndarray) -> float:
        """Megapixels of input in a call."""
        return batch.shape[0] * batch.shape[1] * batch.shape[2] / 1e6

    def counters(self) -> dict:
        """The main path's kernel launches so far in this process."""
        return {name: mod.LAUNCHES for name, mod in self._kernels.items()}

    def record(self) -> dict:
        """The shapes the metric readers need: frames, pixels and the
        matting shape of a call."""
        tr = self.traffic
        return {"frames": tr["frames"],
                "pixels": tr["frames"] * tr["height"] * tr["width"],
                "matting_hw": flops.matting_hw(tr["height"], tr["width"],
                                               self.cfg["matting_dim"])}

    def call_info(self) -> list:
        """Each loop's (B,) iterations in the last compiled call, in the
        program's order (the matting CG, then the Lloyd loop); [] where
        the run was not compiled (the CPU)."""
        progs = list(self.pipe.programs.values())
        return [it.cpu().tolist() for it in progs[-1].iterations()] \
            if progs else []

    def close(self) -> None:
        """Free the program's graphs and memory pools."""
        self.pipe = None
        self._free = []
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
