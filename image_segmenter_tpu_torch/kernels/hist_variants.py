"""K8: the 256-bin histogram as a 16 x 16 nibble table, in step variants.

Replaces the pallas_call inside `hist_variant` of the repo's
bench/micro_hist_nibble.py (kernels `_make_kernel(rows)` for rows 32, 64,
128 and 256 and `_kernel_n3d`). A byte's bin is 16 * hi + lo, so the
histogram is the 16 x 16 table of how often each (high nibble, low
nibble) pair occurs; on the TPU that table is a product of two one-hot
matrices, and the variants differ in how many elements one product takes:
rows x 128, or a whole block of 32,768.

The CUDA kernel (csrc/hist_variants.cu) keeps the table and the question:
each warp counts into a private 16 x 16 table in shared memory, and the
variant is how many elements a block folds before it merges its tables
(N32, N64, N128, N256: 4,096 to 32,768; N3D: its whole share of the row in
one pass). K1's contract: (B, N) uint8 -> (B, 256) float32, exact.

`hist_variant` routes by device: a CUDA tensor launches the kernel, a CPU
tensor takes `hist_variant_plain`, which forms the table as the TPU
kernels do, one one-hot product per step.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.backend import targets_cuda

# variant -> elements folded per merge (0: the block's whole share)
STEPS = {"N32": 32 * 128, "N64": 64 * 128, "N128": 128 * 128,
         "N256": 256 * 128, "N3D": 0}
_BLOCK = 256 * 128  # the TPU kernels' block, N3D's step in the plain version

LAUNCHES = 0  # kernel launches in this process (read by chip_smoke.py)
VARIANT_LAUNCHES = {name: 0 for name in STEPS}

_PLAIN_CHUNK = 1 << 20  # elements whose one-hots are live at once


def _check(x: torch.Tensor, variant: str) -> None:
    if x.dim() != 2 or x.dtype != torch.uint8:
        raise ValueError(f"hist_variant takes (B, N) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if variant not in STEPS:
        raise ValueError(f"hist_variant: unknown variant {variant!r}; one of "
                         f"{sorted(STEPS)}")


def hist_variant(x: torch.Tensor, variant: str = "N3D") -> torch.Tensor:
    """(B, N) uint8 -> (B, 256) float32 exact counts per row."""
    _check(x, variant)
    if not targets_cuda(x):
        return hist_variant_plain(x, variant)
    global LAUNCHES
    if not x.is_contiguous():
        raise ValueError("hist_variant: input must be contiguous")
    b, n = x.shape
    counts = torch.empty((b, 256), dtype=torch.int32, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.iseg_hist_variant(x.data_ptr(), n, b, STEPS[variant],
                               counts.data_ptr(), stream)
    _build.check(rc, f"hist_variant {variant}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
    return counts.to(torch.float32)


def hist_variant_plain(x: torch.Tensor, variant: str = "N3D") -> torch.Tensor:
    """The nibble table by one-hot products, one per step: for every step
    of the variant's size, table += onehot(hi) @ onehot(lo)^T in float32
    (exact: a step counts far below 2^24), the steps' tables summed in
    int32. The last step is padded with zeros and the padding taken off
    bin 0, as the TPU wrapper does."""
    _check(x, variant)
    b, n = x.shape
    step = STEPS[variant] or _BLOCK
    nib = torch.arange(16, dtype=torch.int32, device=x.device)[:, None]
    table = torch.zeros((b, 16, 16), dtype=torch.int32, device=x.device)
    per = max(step, _PLAIN_CHUNK // step * step)
    for s in range(0, n, per):
        chunk = x[:, s:s + per].to(torch.int32)
        pad = -chunk.shape[1] % step
        chunk = torch.nn.functional.pad(chunk, (0, pad))
        steps = chunk.reshape(b, -1, 1, step)
        hi = ((steps >> 4) == nib).to(torch.float32)           # (B, c, 16, step)
        lo = ((steps & 15) == nib).to(torch.float32)
        part = torch.matmul(hi, lo.transpose(2, 3))            # (B, c, 16, 16)
        table += part.to(torch.int32).sum(dim=1, dtype=torch.int32)
        table[:, 0, 0] -= pad
    return table.reshape(b, 256).to(torch.float32)
