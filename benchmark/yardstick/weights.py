"""A configuration's weights, made on the device from its weight seed.

The benchmark's own initialiser, with the semantics of Flax's defaults
(which the port's and the JAX package's seeded sessions use): LeCun
normal convolution kernels, a normal cut at +-2 and rescaled to unit
variance, times 1 / sqrt(fan_in); zero biases; BatchNorm scale 1, shift
0, running mean 0 and running variance 1. All kernels come from one
draw of uniforms by one `torch.Generator` on the device, mapped through
the inverse normal CDF, and each kernel takes its slice. The same seed
gives the same tensors on the same kind of device. The names and shapes
are those of the reference's network (`reference/nets.py`), which are
the port's.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import nets

# Flax's variance_scaling truncated normal: a standard normal cut at +-2,
# rescaled by this constant so the cut distribution keeps unit variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def make_state(arch: str, seed: int, device) -> dict:
    """{name: tensor} for `arch`'s network, float32 on `device`."""
    shapes = nets.build(arch).state_dict()
    kernels = [(k, v.shape) for k, v in shapes.items()
               if k.endswith("weight") and v.dim() == 4]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u) - 1.0)
    state, pos = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        std = 1.0 / math.sqrt(math.prod(shape[1:])) / _TRUNC_STD
        state[name] = z[pos:pos + n].view(shape).mul_(std)
        pos += n
    for name, v in shapes.items():
        if name in state:
            continue
        fill = 1.0 if name.endswith(("bn_s1.weight", "running_var")) else 0.0
        state[name] = torch.full(v.shape, fill, dtype=v.dtype, device=device)
    return state
