"""Microbench: the step-size variants of the nibble histogram (K8)
against the shipped histogram (K1).

Counterpart of the repo's bench/micro_hist_nibble.py, which asked on the
TPU how many elements to put into one one-hot product. Here every variant
of `kernels.hist_variants.hist_variant` (N32, N64, N128, N256, N3D: the
elements a block folds into its private tables before it merges them) and
K1 (`kernels.histogram.hist256`) count the same inputs:

- "random": uniform bytes from numpy's default_rng(0), one row of n and
  `rows` rows of n, as the TPU bench;
- "run": the `rows` rows with the first 2^20 elements of each set to one
  value (lanes of a warp that add to one address);
- "alpha-like": `rows` rows of an elliptic plane of 255 on 0 with 8 % of
  its bytes random (`micro_precompute_hist.alpha_like`), what the main
  path counts with K1.

Per row two times in ms, medians of 10: `LAUNCHES` calls back to back
between two CUDA events (the host's launch rate where the kernel is
shorter than a wrapper call) and the same calls replayed from a CUDA graph
(`micro_precompute_hist.graph_ms`: the device's time alone). Every count
must equal np.bincount. The script calls the wrappers' public entry points
only, so one copy of it times any tree of the package (PYTHONPATH set to
each in turn, in one call). On a CPU tensor each wrapper takes its plain
version, so a CPU run checks the plumbing only and has no graph time.

    python -m image_segmenter_tpu_torch.bench.micro_hist_nibble [cuda|cpu] [n rows]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.micro_precompute_hist import (
    LAUNCHES, alpha_like, graph_ms)
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
    run = many.copy()
    run[:, :min(RUN_LENGTH, n)] = 255
    return {"random": one[None], f"random x{rows}": many,
            f"run x{rows}": run, f"alpha-like x{rows}": alpha_like(rows, n, rng)}


def run(device="cuda", n: int = 2160 * 3840, rows: int = 4,
        reps: int = 10) -> list:
    """One row per (input, kernel): {"input", "kernel", "ms" (back to
    back), "ms_graph", "exact", "launches"}; `exact` is equality with
    np.bincount on every row; `launches` counts the checking call only."""
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
            launches = K8.LAUNCHES + K1.LAUNCHES - before
            call = lambda: fn(x)  # noqa: E731
            out.append({"input": label, "kernel": name,
                        "ms": median_ms(call, x.is_cuda, reps, LAUNCHES),
                        "ms_graph": graph_ms(call, LAUNCHES, reps)
                        if x.is_cuda else float("nan"),
                        "exact": exact, "launches": launches})
    return out


def main(argv) -> None:
    device = argv[1] if len(argv) > 1 else "cuda"
    n, rows = (int(v) for v in argv[2:4]) if len(argv) > 3 else (2160 * 3840, 4)
    res = run(device, n, rows)
    for row in res:
        print(f"[micro_hist_nibble] {row['input']:14s} {row['kernel']:12s} "
              f"back to back {row['ms']:9.4f} ms, graph {row['ms_graph']:9.4f}"
              f" ms, exact {row['exact']}", flush=True)
    if not all(row["exact"] for row in res):
        raise SystemExit("a histogram variant differs from np.bincount")


if __name__ == "__main__":
    main(sys.argv)
