"""Sweep: K8's warps a block, blocks an SM, loads in flight, and its feed.

Each variant is kernels/csrc/hist_variants.cu with `kThreads` (4 or 8
warps), `kBlocksPerSm` (the register cap of `__launch_bounds__` and the
grid: that many blocks an SM over all rows) and `kInFlight` (16-byte loads
a thread has in flight, 2 or 4) changed, built by nvcc with
the library's flags into a shared library of its own under
kernels/_build/sweep/ (all variants side by side), bound with ctypes, held
to np.bincount and timed on N3D at 4 x 2160 x 3840: `LAUNCHES` calls
replayed from a CUDA graph (`micro_precompute_hist.graph_ms`), median of
`REPS`, on random bytes and on an alpha-like plane. A block of 4 warps
holds 32 KB of counters (up to 7 fit an SM), one of 8 warps 64 KB (3).

The Hopper feed (bench/hist_variants_bulk.cu: the same core, its bytes
brought into a ring of `kStages` 4 KB chunks of shared memory by
cp.async.bulk on mbarriers) is timed beside the shipped 16-byte __ldg
feed: 2 stages at 3 blocks an SM, 4 stages at 2.

    python -m image_segmenter_tpu_torch.bench.sweep_k8
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.micro_precompute_hist import (
    LAUNCHES, REPS, alpha_like, graph_ms)
from image_segmenter_tpu_torch.bench.sweep_k6_k7 import SWEEP_DIR, variant_source
from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels import hist_variants as K8
from image_segmenter_tpu_torch.kernels import histogram as K1

# (threads a block, blocks an SM, loads in flight)
SHAPES = ((128, 4, 2), (128, 6, 2), (256, 2, 2), (256, 3, 2), (256, 3, 4))
# the bulk feed: (stages, blocks an SM), 256 threads
BULK = ((2, 3), (4, 2))
BULK_SRC = Path(__file__).resolve().parent / "hist_variants_bulk.cu"
ROWS, N = 4, 2160 * 3840


def _nvcc(tag: str, cu: Path, *extra: str) -> subprocess.Popen:
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           *extra, "-Xptxas", "-v", "-o", str(SWEEP_DIR / f"{tag}.so"),
           str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all() -> dict:
    """tag -> (C entry, threads, blocks an SM, ptxas's register counts), all
    built at once."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for threads, per_sm, in_flight in SHAPES:
        tag = f"k8_t{threads}_b{per_sm}_f{in_flight}"
        cu = SWEEP_DIR / f"{tag}.cu"
        cu.write_text(variant_source("hist_variants.cu", kThreads=threads,
                                     kBlocksPerSm=per_sm,
                                     kInFlight=in_flight))
        procs[tag] = ("iseg_hist_variant", threads, per_sm, _nvcc(tag, cu))
    for stages, per_sm in BULK:
        tag = f"k8_bulk_s{stages}_b{per_sm}"
        procs[tag] = ("iseg_hist_variant_bulk", K8.THREADS, per_sm,
                      _nvcc(tag, BULK_SRC, f"-DK8_STAGES={stages}"))
    libs = {}
    for tag, (entry, threads, per_sm, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:  # reported, and main fails at its end
            print(f"[sweep_k8] nvcc failed for {tag}:\n{log}", flush=True)
            continue
        fn = getattr(ctypes.CDLL(str(SWEEP_DIR / f"{tag}.so")), entry)
        fn.argtypes = _build.SIGNATURES["iseg_hist_variant"]
        fn.restype = ctypes.c_int
        regs = "/".join(sorted(set(re.findall(r"Used (\d+) registers", log))))
        libs[tag] = (fn, threads, per_sm, regs)
    return libs


def blocks_per_row(n: int, b: int, sms: int, threads: int, per_sm: int) -> int:
    """`kernels.hist_variants.blocks_per_row` for another block shape."""
    want = -(-n // (threads * 16 * K8.MAX_LOADS))
    return max(1, min(want, per_sm * sms // max(b, 1)))


def sweep(libs, sms: int) -> list:
    rng = np.random.default_rng(0)
    inputs = {"random": rng.integers(0, 256, (ROWS, N), dtype=np.uint8),
              "alpha-like": alpha_like(ROWS, N, rng)}
    stream = torch.cuda.current_stream().cuda_stream
    scratch = K1._scratch_for(torch.device("cuda", 0), stream, ROWS)
    rows = []
    for name, xh in inputs.items():
        x = torch.from_numpy(xh).cuda()
        ref = np.stack([np.bincount(r, minlength=256) for r in xh]) \
            .astype(np.float32)
        k1 = graph_ms(lambda: K1.hist256(x))
        for tag, (fn, threads, per_sm, regs) in libs.items():
            blocks = blocks_per_row(N, ROWS, sms, threads, per_sm)
            out = torch.empty((ROWS, 256), dtype=torch.float32, device="cuda")

            def call():
                rc = fn(
                    x.data_ptr(), N, ROWS, K8.STEPS["N3D"], blocks,
                    scratch.data_ptr(), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                _build.check(rc, tag)
            call()
            exact = bool(np.array_equal(out.cpu().numpy(), ref))
            rows.append({"input": name, "variant": tag, "registers": regs,
                         "blocks_per_row": blocks, "exact": exact,
                         "ms_graph": graph_ms(call, LAUNCHES, REPS),
                         "k1_ms_graph": k1})
    return rows


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA GPU")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[sweep_k8] {out.stdout.strip()}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_all()
    rows = sweep(libs, sms)
    for row in rows:
        print("[sweep_k8] " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    if not all(row["exact"] for row in rows):
        raise SystemExit("a variant differs from np.bincount")
    if len(libs) < len(SHAPES) + len(BULK):
        raise SystemExit("a variant did not build")


if __name__ == "__main__":
    main(sys.argv)
