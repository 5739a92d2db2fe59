"""Segment Anything's weights, made on the device from a configuration's
weight seed.

The benchmark's own initialiser, with the semantics the port seeds SAM
by (models/sam.seeded_init): LeCun normal kernels for the linears and
the (transposed) convolutions, a normal cut at +-2 and rescaled to unit
variance, times 1 / sqrt(fan_in); zero biases; LayerNorms 1 and 0;
`pos_embed`, `rel_pos_h` and `rel_pos_w` N(0, 0.02^2); the embeddings
and the Gaussian frequency matrix N(0, 1). The kernels come from one
draw of uniforms by one `torch.Generator` on the device, mapped through
the inverse normal CDF, each kernel its slice; the rest from normals of
the same generator, in the state dict's order. The same seed gives the
same tensors on the same kind of device. The names and shapes are those
of the reference's network (`reference/sam_plain.py`), which are the
port's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference import sam_plain

_TRUNC_STD = 0.87962566103423978
_SMALL = ("pos_embed", "rel_pos_h", "rel_pos_w")


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.Linear):
        return w.shape[1]
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


@torch.no_grad()
def make_state(config: dict, seed: int, device) -> dict:
    """{name: tensor} for the configuration's SAM, float32 on `device`."""
    with torch.device("meta"):
        net = sam_plain.SamPlain(config["arch"], **config["widths"])
    kinds = {}
    for mname, m in net.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            kinds[pre + "weight"] = ("kernel", _fan_in(m))
            kinds[pre + "bias"] = ("zero", 0)
        elif isinstance(m, (nn.LayerNorm, sam_plain.LayerNorm2d)):
            kinds[pre + "weight"] = ("one", 0)
            kinds[pre + "bias"] = ("zero", 0)
    shapes = net.state_dict()
    kernels = [(k, v.shape) for k, v in shapes.items()
               if kinds.get(k, ("",))[0] == "kernel"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(sum(math.prod(s) for _, s in kernels), generator=gen,
                   device=device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u) - 1.0)
    del u
    state, pos = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        std = 1.0 / math.sqrt(kinds[name][1]) / _TRUNC_STD
        state[name] = z[pos:pos + n].view(shape).mul_(std)
        pos += n
    for name, v in shapes.items():
        if name in state:
            continue
        kind = kinds.get(name, ("normal",))[0]
        if kind in ("one", "zero"):
            state[name] = torch.full(v.shape, 1.0 if kind == "one" else 0.0,
                                     device=device)
        else:
            std = 0.02 if name.rsplit(".", 1)[-1] in _SMALL else 1.0
            state[name] = torch.randn(v.shape, generator=gen,
                                      device=device).mul_(std)
    return state
