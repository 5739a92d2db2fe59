"""Microbench: one iteration of the matting CG, plain against fused.

`CGLoop.step` runs `CG_CHUNK` iterations: through `_body` (PyTorch
operations, "plain") or through K3 and kernels/cg_update.py's three
kernels ("fused"). Each is captured as a CUDA graph from the same start
(the photo mosaic of the benchmark at the solve's size, a trimap with
known background and foreground bands, rtol 0 so that every image
advances) and replayed `REPS` times from that start, each replay timed
alone between two CUDA events: the device's time for a chunk, over
`CG_CHUNK` an iteration. Then the fused graph is replayed under
torch.profiler for each kernel's device time an iteration, beside its
bound: the float32 planes it reads and writes on an iteration that
advances, x 4 bytes x pixels, at 3.35 TB/s. The two paths' states after
a replay are compared bit for bit. chip_smoke.py's phase 3 runs `run` at
4 x 576 x 1024.

    python -m image_segmenter_tpu_torch.bench.micro_cg_iter [B H W ...]

(default 4 576 1024 and 1 576 1024; one JSON line a shape on stdout).
It needs a card: CUDA graphs have no CPU counterpart.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from image_segmenter_tpu_torch.bench.bench import card_label, photo_batch
from image_segmenter_tpu_torch.solvers import matting as M

REPS = 10
HBM_BPS = 3.35e12
# planes a pixel each kernel reads and writes on an iteration that
# advances (csrc/cg_update.cu): cg_dot L q, q, known, p and y; cg_advance
# y, p, x, r, m_inv, x and r; cg_direction m_inv, r, p, p and q (no q in
# the chunk's last iteration); K3 its 15 (kernels/matvec.py)
PLANES = {"cg_dot_kernel": 5, "cg_advance_kernel": 7,
          "cg_direction_kernel": 5 - 1 / M.CG_CHUNK, "matvec_kernel": 15}
STATE = ("x", "r", "p")
SCALARS = ("rz", "pending", "it", "active", "flag")


def bound_ms(planes: float, pixels: int) -> float:
    """The least time for `planes` float32 planes of `pixels` moved once."""
    return planes * 4 * pixels / HBM_BPS * 1e3


def make_loop(b: int, h: int, w: int, dev, rtol: float = 0.0,
              max_iter: int = 1 << 30) -> M.CGLoop:
    """A CG on the photo mosaic at (h, w): background in the left fifth,
    foreground in the right fifth, unknown between, warm-started at a
    ramp; rtol 0 keeps every image advancing."""
    img = torch.from_numpy(photo_batch(b, h, w)).to(dev)
    tri = torch.full((b, h, w), 0.5, device=dev)
    tri[..., : w // 5] = 0.0
    tri[..., w - w // 5:] = 1.0
    x0 = torch.linspace(0.0, 1.0, w, device=dev).expand(b, h, w)
    return M.CGLoop(img.to(torch.float32) / 255.0, tri, rtol=rtol,
                    max_iter=max_iter, x0=x0, half_stats=True)


def _state(loop) -> list:
    return [getattr(loop, n).blocks[0] for n in STATE] + \
        [getattr(loop, n) for n in SCALARS]


def capture(loop, step):
    """(graph of one `step` from the loop's start, the start's copy)."""
    start = [t.clone() for t in _state(loop)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up: the kernels' library, buffers, the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    return graph, start


def reset(loop, start) -> None:
    for dst, src in zip(_state(loop), start):
        dst.copy_(src)


def time_chunk(loop, graph, start) -> list:
    """ms of each of `REPS` replays, each from the start."""
    out = []
    for _ in range(REPS):
        reset(loop, start)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _device_us(fn) -> dict:
    """Device us of each operation that fn() runs, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    tot: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot[e.name] = tot.get(e.name, 0.0) + e.time_range.elapsed_us()
    return tot


def kernel_ms(loop, step, graph, start, reps: int = 5) -> dict:
    """Device ms an iteration of each operation of `graph`, by name. Each
    replay follows a reset to the start; the reset's copies are left out
    by keeping only the operations that one eager `step` launches."""
    reset(loop, start)
    ops = set(_device_us(step))

    def replays():
        for _ in range(reps):
            reset(loop, start)
            graph.replay()

    return {k: v / 1e3 / (reps * M.CG_CHUNK)
            for k, v in _device_us(replays).items() if k in ops}


def run(b: int, h: int, w: int) -> dict:
    dev = torch.device("cuda")
    fused, plain = make_loop(b, h, w, dev), make_loop(b, h, w, dev)
    assert fused.update == "fused"
    g_fused, s_fused = capture(fused, fused.step)
    g_plain, s_plain = capture(plain, plain._step_plain)
    t_fused = time_chunk(fused, g_fused, s_fused)
    t_plain = time_chunk(plain, g_plain, s_plain)
    same = all(torch.equal(a, c) for a, c in zip(_state(fused),
                                                  _state(plain)))
    by_name = kernel_ms(fused, fused.step, g_fused, s_fused)
    pixels = b * h * w
    kernels = {}
    for name, planes in PLANES.items():
        ms = sum(v for k, v in by_name.items() if name in k)
        bound = bound_ms(planes, pixels)
        kernels[name] = {"ms": ms or None, "bound_ms": bound,
                         "share_of_bound": bound / ms if ms else None}
    cg = sum(PLANES[k] for k in PLANES if k != "matvec_kernel")
    return {"shape": [b, h, w], "card": card_label(dev),
            "iteration_ms": {
                "plain": statistics.median(t_plain) / M.CG_CHUNK,
                "fused": statistics.median(t_fused) / M.CG_CHUNK,
                "plain_range": [min(t_plain) / M.CG_CHUNK,
                                max(t_plain) / M.CG_CHUNK],
                "fused_range": [min(t_fused) / M.CG_CHUNK,
                                max(t_fused) / M.CG_CHUNK]},
            "fused_bound_ms": {"outside_k3": bound_ms(cg, pixels),
                               "with_k3": bound_ms(cg + 15, pixels)},
            "kernels": kernels,
            "fused_ops_ms": {k: v for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])},
            "bits_equal": same}


def main(argv=None) -> int:
    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    shapes = [tuple(args[i:i + 3]) for i in range(0, len(args), 3)] or \
        [(4, 576, 1024), (1, 576, 1024)]
    if not torch.cuda.is_available():
        raise RuntimeError("micro_cg_iter times CUDA graphs: it needs a card")
    for shape in shapes:
        print(json.dumps(run(*shape)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
