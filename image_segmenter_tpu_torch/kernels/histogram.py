"""K1: exact 256-bin histograms of u8 rows.

Replaces image_segmenter_tpu/kernels/pallas_histogram.py (`hist256`, both
the nibble/MXU `_kernel_nibble` and the compare `_kernel`). The CUDA
kernel (csrc/histogram.cu) is the whole call, one launch: about two
resident blocks an SM walk the rows and count with shared-memory atomics
into a table per warp, each block folds its tables into int32 totals of
its row, and the row's last block writes the float32 counts (exact below
2^24 an image, as the JAX package's) and puts the totals back to zero. No
padding, no bin-0 correction, no memset and no cast beside the kernel.

The totals live in a small int32 scratch that is all zero between calls.
`hist256` keeps one per device and stream, zeroed once when it is made, so
calls on one stream follow each other and calls on two streams never share
one. A CUDA graph captured on a stream (pipeline/compiled.py) holds that
stream's scratch by address and replays K1 on it, which the epilogue
leaves zero for the next replay; so a scratch is never freed, not even
when a larger one replaces it.

`hist256` routes by device: a CUDA tensor launches the kernel, a CPU
tensor takes `hist256_plain`, the compare-reduce of
image_segmenter_tpu/ops/histogram.py:38-41.
"""

from __future__ import annotations

import torch

from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.utils.backend import sm_count, targets_cuda
from image_segmenter_tpu_torch.utils.profiling import replayed_counter

# kernel launches in this process (read by chip_smoke.py)
LAUNCHES = replayed_counter(__name__, "LAUNCHES")

_PLAIN_CHUNK = 1 << 16  # elements per compare-reduce step (bounds the one-hot)

THREADS = 512            # kThreads of csrc/histogram.cu
BLOCK_BYTES = THREADS * 16 * 4   # a block is worth launching for 4 loads a thread
BLOCKS_PER_SM = 2        # resident blocks an SM over all rows of a call
SCRATCH_ROW = 257        # int32 a row of the scratch: 256 totals and the ticket
_MIN_SCRATCH_ROWS = 8

_scratch = {}  # (device index, stream) -> (rows, 257) int32, zero between calls
_retired = []  # scratch outgrown on its stream, kept for the graphs that read it


def blocks_per_row(n: int, b: int, sms: int) -> int:
    """Blocks of K1 that share one row of `n` bytes in a call of `b` rows
    on a card of `sms` SMs: one for every `BLOCK_BYTES`, and over all rows
    no more than `BLOCKS_PER_SM` for each SM."""
    want = -(-n // BLOCK_BYTES)
    return max(1, min(want, BLOCKS_PER_SM * sms // max(b, 1)))


def _scratch_for(device: torch.device, stream: int, b: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.shape[0] < b:
        if buf is not None:
            # a CUDA graph captured on this stream may hold it: never free
            _retired.append(buf)
        buf = torch.zeros((max(b, _MIN_SCRATCH_ROWS), SCRATCH_ROW),
                          dtype=torch.int32, device=device)
        _scratch[key] = buf
    return buf


def hist256(x: torch.Tensor) -> torch.Tensor:
    """(B, N) uint8 -> (B, 256) float32 exact counts per row."""
    if x.dim() != 2 or x.dtype != torch.uint8:
        raise ValueError(f"hist256 takes (B, N) uint8, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if not targets_cuda(x):
        return hist256_plain(x)
    global LAUNCHES
    if not x.is_contiguous():
        raise ValueError("hist256: input must be contiguous")
    b, n = x.shape
    out = torch.empty((b, 256), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = _scratch_for(x.device, stream, b)
    # the C entry launches on the current device, which must own the stream
    with torch.cuda.device(x.device):
        rc = lib.iseg_hist256(x.data_ptr(), n, b,
                              blocks_per_row(n, b, sm_count(x.device)),
                              scratch.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "hist256")
    LAUNCHES += 1
    return out


def hist256_plain(x: torch.Tensor) -> torch.Tensor:
    """Compare-reduce histogram: sum over elements of (x == bin), int32."""
    b, n = x.shape
    bins = torch.arange(256, dtype=torch.int32, device=x.device)
    counts = torch.zeros((b, 256), dtype=torch.int32, device=x.device)
    for s in range(0, n, _PLAIN_CHUNK):
        chunk = x[:, s:s + _PLAIN_CHUNK].to(torch.int32)
        counts += (chunk[:, :, None] == bins).sum(dim=1, dtype=torch.int32)
    return counts.to(torch.float32)
