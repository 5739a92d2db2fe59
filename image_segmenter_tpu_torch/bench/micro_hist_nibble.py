"""Microbench: the step-size variants of the nibble histogram (K8)
against the shipped histogram (K1).

Counterpart of the repo's bench/micro_hist_nibble.py, which asked on the
TPU how many elements to put into one one-hot product. Here every variant
of `kernels.hist_variants.hist_variant` (N32, N64, N128, N256, N3D: the
elements a block folds into its private tables before it merges them) and
K1 (`kernels.histogram.hist256`) count the same inputs:

- "random": uniform bytes from numpy's default_rng(0), one row of n and
  `rows` rows of n, as the TPU bench;
- "run": the same row with its first 2^20 elements set to one value, the
  input on which K1's per-warp tables contend.

Every count must equal np.bincount. On a CPU tensor each wrapper takes its
plain version, so a CPU run checks the plumbing only.

    python -m image_segmenter_tpu_torch.bench.micro_hist_nibble [cuda|cpu] [n rows]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.micro_quantize import median_ms
from image_segmenter_tpu_torch.kernels import hist_variants as K8
from image_segmenter_tpu_torch.kernels import histogram as K1
from image_segmenter_tpu_torch.utils.backend import resolve_device

RUN_LENGTH = 1 << 20


def inputs(n: int, rows: int, seed: int = 0) -> dict:
    """name -> (rows_i, n) uint8 numpy arrays."""
    rng = np.random.default_rng(seed)
    one = rng.integers(0, 256, n, dtype=np.uint8)
    many = rng.integers(0, 256, (rows, n), dtype=np.uint8)
    run = one.copy()
    run[:min(RUN_LENGTH, n)] = 255
    return {"random": one[None], f"random x{rows}": many, "run": run[None]}


def run(device="cuda", n: int = 2160 * 3840, rows: int = 4,
        reps: int = 10) -> list:
    """One row per (input, kernel): {"input", "kernel", "ms", "exact",
    "launches"}; `exact` is equality with np.bincount on every row."""
    dev = resolve_device(device)
    kernels = {name: (lambda x, v=name: K8.hist_variant(x, v))
               for name in K8.STEPS}
    kernels["K1 hist256"] = K1.hist256
    out = []
    for label, xh in inputs(n, rows).items():
        ref = np.stack([np.bincount(r, minlength=256) for r in xh]) \
            .astype(np.float32)
        x = torch.from_numpy(xh).to(dev)
        for name, fn in kernels.items():
            before = K8.LAUNCHES + K1.LAUNCHES
            exact = bool(np.array_equal(fn(x).cpu().numpy(), ref))
            ms = median_ms(lambda: fn(x), x.is_cuda, reps)
            out.append({"input": label, "kernel": name, "ms": ms,
                        "exact": exact,
                        "launches": K8.LAUNCHES + K1.LAUNCHES - before})
    return out


def main(argv) -> None:
    device = argv[1] if len(argv) > 1 else "cuda"
    n, rows = (int(v) for v in argv[2:4]) if len(argv) > 3 else (2160 * 3840, 4)
    res = run(device, n, rows)
    for row in res:
        print(f"[micro_hist_nibble] {row['input']:12s} {row['kernel']:12s} "
              f"{row['ms']:9.4f} ms  exact {row['exact']}", flush=True)
    if not all(row["exact"] for row in res):
        raise SystemExit("a histogram variant differs from np.bincount")


if __name__ == "__main__":
    main(sys.argv)
