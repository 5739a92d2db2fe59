"""Device routing for the port.

One rule, the counterpart of image_segmenter_tpu/utils/backend.targets_tpu:
a tensor on a CUDA device goes to the hand-written kernel, a tensor on the
CPU goes to the kernel's plain PyTorch version. A wrapper never falls back
from the kernel to the plain version.
"""

from __future__ import annotations

import functools

import torch


def targets_cuda(t: torch.Tensor) -> bool:
    """Whether `t` is on a CUDA device (kernel) rather than the CPU (plain)."""
    return t.is_cuda


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card `device` names; the wrappers
    size their kernels' grids by it."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


def strict_f32() -> None:
    """Keep float32 math in float32 on the card.

    cuDNN runs float32 convolutions in TF32 by default, and a matmul may
    be allowed to. TF32 keeps about three decimal digits; the resize
    contractions feed floor(x + 0.5) u8 rounding and `_pairwise_d2` feeds
    k-means argmins, which the JAX package computes at full f32
    (HIGHEST) precision. Both switches stay off.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s for a float scalar s, rounded as one float division on every
    device.

    PyTorch's CUDA kernels divide by a Python scalar as x * (1 / s), which
    rounds differently from the CPU's (and XLA's) x / s for many inputs:
    126 of the 256 u8 levels at s = 255. A divisor that lives on x's
    device takes the true division on both.
    """
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but CUDA is not "
                "available; pass device='cpu' to run the plain path")
        strict_f32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {device!r}")
    return dev
