"""The reference of the `pipeline_run_birefnet` entry, and the comparison
that decides `correct`.

`Reference(config, state, device, control=False, cnn="f32")` is
`pipeline_run`'s reference (the main path in plain PyTorch, float32 with
TF32 off, one frame at a time) with BiRefNet in the CNN's place:
`birefnet_plain.BiRefNetPlain` on the PIL-Lanczos input at 1024 x 1024,
max-scaled and normalised, and the sigmoid of its logits before the
min-max (rembg's BiRefNetSessionGeneral); then Lanczos back up, the
matting, the close and open, the k-means and the palette map. With
`control=True` it is the control: every linear's and convolution's
operands (conv_out1's aside) in float8 e4m3, and the matting and k-means
state in bfloat16 (`plain.py`). With `cnn="bf16"` those operands are
rounded to bfloat16, the configuration's own arithmetic: a witness. It
takes the weights the benchmark made, nothing the program made.

`judge` is `pipeline_run.judge`: `alpha_mad` within the cell's
tolerance, `rgba_mismatch` and `palette_mismatch` exact.
"""

from __future__ import annotations

import torch

from benchmark.reference import birefnet_plain, pipeline_run
from benchmark.reference.pipeline_run import judge  # noqa: F401


class _Saliency(torch.nn.Module):
    """The network and rembg's sigmoid: what `pipeline_run.Reference`
    min-maxes."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return torch.sigmoid(self.net(x))


class Reference(pipeline_run.Reference):
    def __init__(self, config: dict, state: dict, device, control=False,
                 cnn: str = "f32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = config
        self.device = torch.device(device)
        self.control = control
        with torch.device("meta"):
            net = birefnet_plain.BiRefNetPlain("fp8" if control else cnn,
                                               **config["widths"])
        net.load_state_dict(state, assign=True)
        self.net = _Saliency(net)
        self.mean = torch.tensor(config["mean"], device=self.device)
        self.std = torch.tensor(config["std"], device=self.device)
