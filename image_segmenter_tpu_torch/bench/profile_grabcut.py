"""Where a GrabCut call spends its time on the card.

    python -m image_segmenter_tpu_torch.bench.profile_grabcut [H W]

Runs `compat.grabcut.apply_grabcut` on seeded portrait scenes
(`utils/seeds.portrait_scene`, which chip_smoke.py phase 10 drives too;
default 1024 x 768, BASELINE config 4's shape and rect, 10 iterations,
the split-merge polish): one plain call per scene, then one in which
the solver's functions are wrapped with a synchronise and a host clock
on either side, nested by caller, printed as seconds and calls per
function. Then torch.profiler over 100 iterations of the Chambolle-Pock
loop at 1 x H x W: wall, device busy, idle share and device operations.
The wrapped call is slower than the plain one by its synchronises.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import time

import torch

from image_segmenter_tpu_torch.compat import grabcut as GRABCUT
from image_segmenter_tpu_torch.solvers import grabcut as GC
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils.backend import strict_f32
from image_segmenter_tpu_torch.utils.seeds import config4_rect, portrait_scene


_WRAPPED = [(GC, "_grabcut_init"), (GC, "_init_gmm"), (KM, "kmeans_fit"),
            (GC, "_grabcut_iter"), (GC, "tv_mincut"), (GC, "mask_energy"),
            (GC, "_splitmerge_polish"), (GC, "_polish_round"),
            (GC, "_split_candidates")]


def _instrument(acc: dict, calls: collections.Counter):
    """Wrap the solver's functions; returns a function that unwraps."""
    stack = []
    saved = []

    def wrap(mod, name):
        inner = getattr(mod, name)
        saved.append((mod, name, inner))

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stack.append(name)
            try:
                return inner(*a, **k)
            finally:
                torch.cuda.synchronize()
                key = "/".join(stack)
                stack.pop()
                acc[key] += time.perf_counter() - t0
                calls[key] += 1
        setattr(mod, name, timed)

    for mod, name in _WRAPPED:
        wrap(mod, name)

    def undo():
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return undo


def _rounded(info: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in info.items()}


def main(h: int = 1024, w: int = 768) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_grabcut needs a CUDA device")
    strict_f32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    rect = config4_rect(h, w)
    seeds = (21, 22)
    for seed in seeds:
        bgr, _ = portrait_scene(h, w, seed)
        t0 = time.perf_counter()
        GRABCUT.apply_grabcut(bgr, rect_xywh=rect, iterations=10)
        print(f"plain {h}x{w} scene {seed}: {time.perf_counter() - t0:.4f} s "
              f"{_rounded(GC.LAST_SOLVE_INFO)}")
    for seed in seeds:
        acc, calls = collections.defaultdict(float), collections.Counter()
        undo = _instrument(acc, calls)
        try:
            bgr, _ = portrait_scene(h, w, seed)
            t0 = time.perf_counter()
            GRABCUT.apply_grabcut(bgr, rect_xywh=rect, iterations=10)
            wall = time.perf_counter() - t0
        finally:
            undo()
        print(f"wrapped {h}x{w} scene {seed}: {wall:.4f} s "
              f"{_rounded(GC.LAST_SOLVE_INFO)}")
        for key in sorted(acc, key=lambda k: -acc[k]):
            print(f"  {key}: {acc[key]:.4f} s over {calls[key]} calls")

    g = torch.Generator(device="cuda").manual_seed(25)
    unary = torch.randn((1, h, w), generator=g, device="cuda") * 4
    wts = GC._nlink_weights(torch.rand((3, h, w), generator=g,
                                       device="cuda") * 255)
    free = torch.zeros((1, h, w), dtype=torch.bool, device="cuda")
    GC.tv_mincut(unary, wts, free, free, max_iter=100)  # warm-up
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        GC.tv_mincut(unary, wts, free, free, max_iter=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    print(f"Chambolle-Pock loop, 100 iterations at 1x{h}x{w}, profiled: wall "
          f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {len(kernels)} device operations")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
