"""Model registry and sessions for the rembg model ids.

Counterpart of image_segmenter_tpu/models/registry.py. A session owns one
network on one device. Its weights come from the model's rembg `.onnx`
checkpoint when one is found (an explicit `ckpt_path`, else
$U2NET_HOME/<id>.onnx, else ~/.u2net/<id>.onnx), loaded strictly through
models/onnx_import.py: a file that maps only in part is refused. Without
one they are seeded as the JAX package seeds them (Flax's default
initialisers: lecun-normal conv kernels, zero biases, identity BatchNorm
statistics), drawn from an explicit CPU `torch.Generator` so that every
device gets the same weights. `Session.load_state_dict` loads a state
dict (models/convert.state_from_flax carries the JAX package's variables
over).

Pre- and postprocessing follow rembg's sessions/base.py, as the JAX
package's do: PIL-Lanczos resize to the model's input size, divide by the
image max, mean/std normalisation, min-max normalisation of the predicted
saliency, Lanczos resize back to the input's size.

Segment Anything (`sam_vit_h`, and `sam`, rembg's id for the ViT-B size
of the same code) is a model of another kind, "prompted": it takes one
box a frame, and its pre- and postprocessing are SamPredictor's
(models/sam.py: the longest side to 1024 by PIL's bilinear filter,
0-255 values normalised by a mean and std a channel, zero padding to
1024 x 1024, logits thresholded at 0). It runs through
`Pipeline.run(imgs, boxes)`; `predict_mask` refuses it. Its weights are
seeded (models/sam.seeded_init) by a generator on the session's device,
since a host's generator takes tens of seconds for ViT-H's 641 M
parameters: the same seed gives the same weights on the same kind of
device, not on every device as for the CNNs. No checkpoint is
discovered for it.

BiRefNet (`birefnet-general`, rembg's session of the Swin-L general
model: models/birefnet.py) is a saliency model whose spec adds a sigmoid
before the min-max (`post="sigmoid"`, rembg's
BiRefNetSessionGeneral.predict). Like SAM, its weights are seeded on the
session's device (models/birefnet.seeded_init) and no checkpoint is
discovered for it; its network stage is a graph of its own on the card.
"""

from __future__ import annotations

import math
import os
import sys
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from image_segmenter_tpu_torch.models import birefnet as BRN
from image_segmenter_tpu_torch.models import onnx_import as OIMP
from image_segmenter_tpu_torch.models import sam as SAM
from image_segmenter_tpu_torch.models import u2net as NETS
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.utils.backend import resolve_device


@dataclass(frozen=True)
class ModelSpec:
    arch: str                 # "u2net" | "u2netp" | "isnet" | "sam_vit_*"
    #                           | "birefnet_swin_l"
    size: Tuple[int, int]     # network input (H, W)
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    out_ch: int = 1
    # "saliency": resize to `size`, divide by the image max, min-max the
    # output; "prompted": SamPredictor's path, one box a frame
    kind: str = "saliency"
    # a saliency model's map before the min-max: "identity" or "sigmoid"
    post: str = "identity"
    # weights seeded by the model's own `seeded_init` with a generator on
    # the session's device (a host's takes tens of seconds for SAM and
    # BiRefNet), and no rembg checkpoint discovered
    seeded_on_device: bool = False
    # the network stage a compiled graph of its own, its
    # `compiled.segment` spans naming the model
    own_graph: bool = False

    @property
    def prompted(self) -> bool:
        return self.kind == "prompted"


SPECS = {
    "u2net": ModelSpec("u2net", (320, 320), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "u2netp": ModelSpec("u2netp", (320, 320), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "u2net_human_seg": ModelSpec("u2net", (320, 320), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "silueta": ModelSpec("u2net", (320, 320), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "u2net_cloth_seg": ModelSpec("u2net", (768, 768), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), out_ch=4),
    "isnet-general-use": ModelSpec("isnet", (1024, 1024), (0.5, 0.5, 0.5), (1.0, 1.0, 1.0)),
    "isnet-anime": ModelSpec("isnet", (1024, 1024), (0.5, 0.5, 0.5), (1.0, 1.0, 1.0)),
    "sam_vit_h": ModelSpec("sam_vit_h", (1024, 1024), SAM.PIXEL_MEAN, SAM.PIXEL_STD, kind="prompted", seeded_on_device=True, own_graph=True),
    "sam": ModelSpec("sam_vit_b", (1024, 1024), SAM.PIXEL_MEAN, SAM.PIXEL_STD, kind="prompted", seeded_on_device=True, own_graph=True),
    "birefnet-general": ModelSpec("birefnet_swin_l", (1024, 1024), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), post="sigmoid", seeded_on_device=True, own_graph=True),
}

# Flax's variance_scaling truncated normal: a standard normal cut at +-2,
# rescaled by this constant so the cut distribution keeps unit variance
_TRUNC_STD = 0.87962566103423978


def _build(spec: ModelSpec, half: bool) -> torch.nn.Module:
    if spec.prompted:
        return SAM.build(spec.arch, half)
    if spec.arch in BRN.CONFIGS:
        return BRN.build(spec.arch, half)
    if spec.arch == "u2net":
        return NETS.U2NET(out_ch=spec.out_ch, small=False, half=half)
    if spec.arch == "u2netp":
        return NETS.U2NET(out_ch=spec.out_ch, small=True, half=half)
    return NETS.ISNet(out_ch=spec.out_ch, half=half)


def _checkpoint_path(model: str) -> Optional[str]:
    """$U2NET_HOME/<model>.onnx, else ~/.u2net/<model>.onnx, if the file
    exists (rembg's discovery)."""
    home = os.environ.get("U2NET_HOME",
                          os.path.join(os.path.expanduser("~"), ".u2net"))
    p = os.path.join(home, f"{model}.onnx")
    return p if os.path.isfile(p) else None


def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal(0, std) cut at +-2 std, by inverse CDF of seeded uniforms."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 1.0 - lo
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (z * std).to(torch.float32)


@torch.no_grad()
def _seeded_init(module: torch.nn.Module, seed: int) -> None:
    """Flax-default initialisation of every conv and BatchNorm, in module
    order, from one CPU generator."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            m.weight.copy_(_truncated_normal(m.weight.shape, std, gen))
            m.bias.zero_()
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


class Session:
    """One model id on one device: the network and its weights."""

    def __init__(self, model: str, half: bool = True, seed: int = 0,
                 ckpt_path: Optional[str] = None, device="cuda"):
        if model not in SPECS:
            raise ValueError(f"unknown rembg model id: {model}")
        self.device = resolve_device(device)
        self.model_id = model
        self.spec = SPECS[model]
        self.half = half
        if self.spec.seeded_on_device:
            # every tensor is seeded here: skip the default init's draws
            with torch.device("meta"):
                module = _build(self.spec, half)
            module = module.to_empty(device=self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            (SAM if self.spec.prompted else BRN).seeded_init(module, gen)
        else:
            module = _build(self.spec, half)
            _seeded_init(module, seed)
        self.weights_loaded = False
        self.load_report = None
        # an explicit path (tools/verify_checkpoint) overrides discovery
        if self.spec.seeded_on_device and ckpt_path is not None:
            raise ValueError(f"{model}: the checkpoint loader reads rembg "
                             "`.onnx` files of the CNNs; load this model's "
                             "state dict with `Session.load_state_dict`")
        ckpt = ckpt_path if ckpt_path is not None else (
            None if self.spec.seeded_on_device else _checkpoint_path(model))
        if ckpt is not None:
            # Strict: a checkpoint that exists but maps only in part would
            # silently give garbage masks; refuse it instead (onnxruntime,
            # the reference's path, likewise fails loudly on a bad file).
            state, self.load_report = OIMP.load_into_state_dict(
                module, ckpt, strict=True)
            module.load_state_dict(state, strict=True)
            self.weights_loaded = True
            # diagnostic, not output: stdout stays clean for tools that
            # print machine-readable JSON (tools/verify_checkpoint)
            print(f"[models] {model}: {self.load_report.summary()}",
                  file=sys.stderr)
        self.module = module.to(self.device).eval()

    def load_state_dict(self, state) -> None:
        """Load a rembg-named state dict (strict)."""
        self.module.load_state_dict(state, strict=True)
        self.weights_loaded = True

    def _normalize(self, img_u8: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) u8 -> (1, 3, H, W) float32: rembg divides by the
        image max, then subtracts the mean and divides by the std."""
        x = img_u8.to(torch.float32)
        x = x / torch.clamp_min(x.max(), 1e-6)
        mean = torch.tensor(self.spec.mean, dtype=torch.float32,
                            device=x.device)
        std = torch.tensor(self.spec.std, dtype=torch.float32,
                           device=x.device)
        return ((x - mean) / std).permute(2, 0, 1)[None]

    @torch.no_grad()
    def _forward(self, rgb: np.ndarray) -> torch.Tensor:
        """(H, W, 3) u8 image -> the network's fused output (C, nh, nw)
        float32 at the network's input size."""
        x = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        small = RZ.resize_u8(x[None], self.spec.size, RZ.LANCZOS_PIL)[0]
        return self.module(self._normalize(small))[0][0].to(torch.float32)

    def predict_mask(self, rgb: np.ndarray) -> np.ndarray:
        """rembg-style saliency mask: uint8 (H, W) at the input's size.

        Multi-class heads (u2net_cloth_seg: 4 classes, class 0 =
        background) give the union of the non-background classes by
        argmax."""
        if self.spec.prompted:
            raise ValueError(f"{self.model_id} takes a box a frame: use "
                             "Pipeline(model).run(imgs, boxes)")
        d0 = self._forward(rgb)
        if self.spec.out_ch > 1:
            mask = (torch.argmax(d0, dim=0) != 0).to(torch.float32)
        else:
            d0 = d0[0]
            if self.spec.post == "sigmoid":
                d0 = torch.sigmoid(d0)
            mi, ma = d0.min(), d0.max()  # min-max normalise (rembg post)
            mask = (d0 - mi) / torch.clamp_min(ma - mi, 1e-12)
        mask_u8 = torch.clamp(torch.floor(mask * 255.0 + 0.5), 0, 255) \
            .to(torch.uint8)
        return RZ.resize_u8(mask_u8[None], rgb.shape[:2],
                            RZ.LANCZOS_PIL)[0].cpu().numpy()

    def predict_class_masks(self, rgb: np.ndarray) -> np.ndarray:
        """Per-class masks of a multi-class head (rembg's cloth_seg gives
        one mask per garment class): (C - 1, H, W) uint8, class 0 =
        background."""
        cls = torch.argmax(self._forward(rgb), dim=0)
        masks = torch.stack([(cls == c).to(torch.uint8) * 255
                             for c in range(1, self.spec.out_ch)])
        return RZ.resize_u8(masks, rgb.shape[:2], RZ.LANCZOS_PIL) \
            .cpu().numpy()


_sessions_lock = threading.Lock()
_sessions = {}


def new_session(model: str, device="cuda", **kwargs) -> Session:
    """rembg.new_session-compatible factory, cached per (model, device)."""
    key = (model, str(resolve_device(device)), tuple(sorted(kwargs.items())))
    with _sessions_lock:
        sess = _sessions.get(key)
        if sess is None:
            sess = Session(model, device=device, **kwargs)
            _sessions[key] = sess
        return sess
