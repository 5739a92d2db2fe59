"""BiRefNet's weights, made on the device from a configuration's weight
seed.

The benchmark's own initialiser, with the semantics the port seeds
BiRefNet by (models/birefnet.seeded_init): LeCun normal kernels for every
linear and convolution (the deformable branches' offset and modulator
convolutions too), a normal cut at +-2 and rescaled to unit variance,
times 1 / sqrt(fan_in); zero biases; LayerNorms 1 and 0; BatchNorms the
identity (weight 1, bias 0, running mean 0, running variance 1); the
relative-position bias tables N(0, 1); each table's index as the
official code computes it. The kernels come from one draw of uniforms by
one `torch.Generator` on the device, mapped through the inverse normal
CDF, each kernel its slice; the tables from normals of the same
generator, in the state dict's order. The same seed gives the same
tensors on the same kind of device. The names and shapes are those of
the reference's network (`reference/birefnet_plain.py`), which are the
port's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from benchmark.reference import birefnet_plain as BP

_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def make_state(config: dict, seed: int, device) -> dict:
    """{name: tensor} for the configuration's BiRefNet, float32 (the
    tables' index int64) on `device`."""
    with torch.device("meta"):
        net = BP.BiRefNetPlain(**config["widths"])
    kinds = {}
    for mname, m in net.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            kinds[pre + "weight"] = ("kernel", fan_in)
            kinds[pre + "bias"] = ("zero", 0)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            kinds[pre + "weight"] = ("one", 0)
            kinds[pre + "bias"] = ("zero", 0)
            kinds[pre + "running_mean"] = ("zero", 0)
            kinds[pre + "running_var"] = ("one", 0)
            kinds[pre + "num_batches_tracked"] = ("zero", 0)
        elif isinstance(m, BP.WindowAttention):
            kinds[pre + "relative_position_index"] = ("index", m.ws)
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
        kind, arg = kinds.get(name, ("normal", 0))
        if kind == "index":
            state[name] = BP.position_index(arg).to(device)
        elif kind in ("one", "zero"):
            state[name] = torch.full(v.shape, 1 if kind == "one" else 0,
                                     dtype=v.dtype, device=device)
        else:  # relative_position_bias_table
            state[name] = torch.randn(v.shape, generator=gen, device=device)
    return state
