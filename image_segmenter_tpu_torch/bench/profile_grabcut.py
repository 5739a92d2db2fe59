"""Where a GrabCut call spends its time on the card, compiled and eager.

    python -m image_segmenter_tpu_torch.bench.profile_grabcut [H W]
    python -m image_segmenter_tpu_torch.bench.profile_grabcut [H W] \
        --chunks 10,25,50,100

Runs `solvers.grabcut.grabcut_core` on seeded portrait scenes
(`utils/seeds.portrait_scene`, which chip_smoke.py phase 10 drives too;
default 1024 x 768, BASELINE config 4's shape and rect, 10 iterations,
the split-merge polish):

1. per scene the compiled call (its units replayed from CUDA graphs):
   the first call, which warms up and captures the units it reaches,
   and a warm call; then the eager call (`_grabcut_core_eager`, every
   unit op by op), which must give the same bytes and cut iterations.
   The peak and reserved device memory after the first scene's calls;
2. one eager call with each unit (`solvers.grabcut._run`) and the image
   preparation wrapped with a synchronise and a host clock on either
   side: seconds and calls per unit, slower than the plain call by its
   synchronises;
3. one warm compiled call and one eager call under torch.profiler: wall,
   device busy (the union of the device operations' intervals), idle
   share, device operations and host reads (device-to-host copies);
4. the Chambolle-Pock loop alone, 100 iterations at 1 x H x W, eager and
   from a graph, under the profiler: the same columns.

With `--chunks` it sweeps the cut's chunk instead: for each chunk, the
first alternation's cut at 1 x H x W (cold) and the polish's first
batched cut at 10 lanes of the coarse search (warm), their real inputs
taken from a call, each run to its end from a graph: median ms of 5
replays, ms an iteration, the slowest lane's iterations and the host
reads (one a chunk run, one to stop). Every chunk must give the same
bits. The rows print as a table and one JSON line.

With `--restart-chunks` (e.g. 2,4,8) it sweeps the k-means restarts'
chunk (`kmeans.RESTART_CHUNK`) on whole compiled calls: for each chunk
the units are compiled anew, then the median of 3 warm calls on scene
21 with its t_init and t_polish. Every chunk must give the same bytes.

With `--first` it splits the first compiled call of the process at
H x W (scene 21, after a device operation that makes the CUDA context)
into the warm-ups (`utils.loops.warm_up`, fenced by a synchronise), the
captures (capture_begin to capture_end, the host's recording and the
graph's instantiation) and the rest (the replays and the host glue);
then a warm call and the eager call. One JSON line.

With `--one-shot 256x192,1024x768` it times the command line's GrabCut
as a user runs it, one process a call (`python -m
image_segmenter_tpu_torch.cli IN OUT --grabcut-rect R --no-simplify -q`
on a seeded portrait PNG, config 4's rect), so every call is a first
call: the wall of each process, and of one that runs the command line
with no GrabCut (`--no-simplify -q`: start-up, the PNGs, the CUDA
context). `--against DIR` runs the same processes in another checkout
(a parent commit, unpacked), in the order DIR, this, this, DIR, and
checks that both write the same bytes. One JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from image_segmenter_tpu_torch import cli as CLI
from image_segmenter_tpu_torch.pipeline import compiled as CPM
from image_segmenter_tpu_torch.pipeline.compiled import Compiled
from image_segmenter_tpu_torch.solvers import grabcut as GC
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.utils import profiling as PROF
from image_segmenter_tpu_torch.utils.backend import strict_f32
from image_segmenter_tpu_torch.utils.loops import drive
from image_segmenter_tpu_torch.utils.seeds import config4_rect, portrait_scene

SEEDS = (21, 22)
LANES = 2 * GC.K_COMP  # the polish's candidates


def _sync() -> None:
    torch.cuda.synchronize()


def _rounded(info: dict) -> dict:
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in info.items()}


def rect_mask(h: int, w: int) -> np.ndarray:
    """Config 4's rect as an init mask: PR_FGD inside, BGD outside."""
    x, y, rw, rh = config4_rect(h, w)
    mask = np.full((h, w), GC.BGD, np.uint8)
    mask[y:y + rh, x:x + rw] = GC.PR_FGD
    return mask


def solve(fn, bgr, mask):
    """One synchronised call: (mask bytes, seconds, LAST_SOLVE_INFO)."""
    _sync()
    t0 = time.perf_counter()
    out = fn(bgr, mask, iterations=10, device="cuda").cpu().numpy()
    _sync()
    return out, time.perf_counter() - t0, dict(GC.LAST_SOLVE_INFO)


def device_view(fn) -> dict:
    """One call of fn under the profiler: wall, device busy, idle share,
    device operations and device-to-host copies (the host reads)."""
    walls = []

    def call():
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        walls.append(time.perf_counter() - t0)
    ops, intervals = PROF.capture_device_timeline(call)
    busy = PROF.busy_us(intervals) / 1e3
    wall = walls[0] * 1e3
    return {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
            "ops": len(intervals),
            "host_reads": sum(c for n, _, c in ops if "DtoH" in n)}


def _instrument(acc: dict, calls: collections.Counter):
    """Wrap the units and the preparation; returns a function that
    unwraps."""
    stack = []
    run, prepare = GC._run, GC.prepare

    def timed(name, fn, *a, **k):
        _sync()
        t0 = time.perf_counter()
        stack.append(name)
        try:
            return fn(*a, **k)
        finally:
            _sync()
            key = "/".join(stack)
            stack.pop()
            acc[key] += time.perf_counter() - t0
            calls[key] += 1

    GC._run = lambda program, *a, **k: timed(
        program.__name__, run, program, *a, **k)
    GC.prepare = lambda *a: timed("prepare", prepare, *a)

    def undo():
        GC._run, GC.prepare = run, prepare
    return undo


def _row(name: str, view: dict) -> None:
    print(f"{name}: wall {view['wall_ms']:.3f} ms, device busy "
          f"{view['busy_ms']:.3f} ms, idle share {view['idle_share']:.4f}, "
          f"{view['ops']} device operations, {view['host_reads']} host "
          f"reads")


def cut_program(max_iter: int, chunk: int):
    """A program of one cut: (unary, edge_w, fixed_fg, fixed_bg[, y])
    -> (u, it, y)."""
    def program(unary, wts, ffg, fbg, y=None):
        loop = GC.CPLoop(unary, wts, ffg, fbg, max_iter=max_iter, warm_y=y,
                         chunk=chunk)
        yield loop
        return loop.u.clone(), loop.it.clone(), loop.y.clone()
    return program


def recorded_cuts(bgr: np.ndarray, mask: np.ndarray) -> dict:
    """The inputs of two real cuts of an eager call on the card: the first
    alternation's (1 x H x W, cold) and the first batched cut of the
    polish's first round (10 lanes at the coarse search, warm)."""
    got = collections.defaultdict(list)
    real = GC.CPLoop

    class Recording(real):
        def __init__(self, unary, wts, ffg, fbg, max_iter=2000,
                     warm_y=None, chunk=None):
            got[unary.shape[0]].append((unary, wts, ffg, fbg, warm_y))
            super().__init__(unary, wts, ffg, fbg, max_iter, warm_y, chunk)

    GC.CPLoop = Recording
    try:
        solve(GC._grabcut_core_eager, bgr, mask)
    finally:
        GC.CPLoop = real
    one = got[1][0][:4]
    many = got[LANES][0]
    return {f"1x{one[0].shape[1]}x{one[0].shape[2]}": one,
            f"{LANES}x{many[0].shape[1]}x{many[0].shape[2]}": many}


def sweep(h: int, w: int, chunks) -> dict:
    """The cut's chunk swept on two real cuts (see the module doc)."""
    bgr, _ = portrait_scene(h, w, SEEDS[0])
    cuts = recorded_cuts(bgr, rect_mask(h, w))
    rows, same = [], True
    for shape, args in cuts.items():
        ref = None
        for chunk in chunks:
            prog = Compiled(cut_program(2500, chunk),
                            [(t.shape, t.dtype) for t in args],
                            torch.device("cuda"))
            prog(*args)  # warm-up and capture
            times = []
            for _ in range(5):
                _sync()
                t0 = time.perf_counter()
                out = prog(*args)
                _sync()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
            it = int(out[1].max())
            if ref is None:
                ref = out
            same = same and all(torch.equal(a, b) for a, b in zip(out, ref))
            rows.append({"cut": shape, "chunk": chunk, "ms": ms,
                         "ms_all": times, "max_iters": it,
                         "ms_per_iteration": ms / it,
                         "host_reads": -(-it // chunk) + 1})
            del prog
    return {"rows": rows, "same_bits": same}


def restart_sweep(h: int, w: int, chunks) -> dict:
    """The restarts' chunk swept on whole compiled calls."""
    bgr, _ = portrait_scene(h, w, SEEDS[0])
    mask = rect_mask(h, w)
    rows, outs = [], []
    saved = KM.RESTART_CHUNK
    try:
        for chunk in chunks:
            KM.RESTART_CHUNK = chunk
            GC.clear_programs()
            torch.cuda.empty_cache()
            out, first, _ = solve(GC.grabcut_core, bgr, mask)
            calls = [solve(GC.grabcut_core, bgr, mask) for _ in range(3)]
            walls = [c[1] for c in calls]
            info = calls[-1][2]
            outs.append(out)
            rows.append({"chunk": chunk, "first_s": first,
                         "s": statistics.median(walls), "s_all": walls,
                         "t_init": info["t_init"],
                         "t_polish": info.get("t_polish")})
    finally:
        KM.RESTART_CHUNK = saved
        GC.clear_programs()
    return {"rows": rows,
            "same_bytes": all(np.array_equal(o, outs[0]) for o in outs)}


def first_call(h: int, w: int) -> dict:
    """The first compiled call of the process at h x w split into the
    warm-ups, the captures and the rest; a warm call; the eager call."""
    torch.zeros(1, device="cuda")
    _sync()
    bgr, _ = portrait_scene(h, w, SEEDS[0])
    mask = rect_mask(h, w)
    acc = collections.Counter()
    warm, graph = CPM.warm_up, torch.cuda.CUDAGraph
    begin, end = graph.capture_begin, graph.capture_end
    started = []

    def timed_warm(program):
        _sync()
        t0 = time.perf_counter()
        try:
            return warm(program)
        finally:
            _sync()
            acc["warm_up_s"] += time.perf_counter() - t0

    def timed_begin(self, *a, **k):
        started.append(time.perf_counter())
        return begin(self, *a, **k)

    def timed_end(self):
        try:
            return end(self)
        finally:
            acc["capture_s"] += time.perf_counter() - started.pop()
            acc["graphs"] += 1

    CPM.warm_up = timed_warm
    graph.capture_begin, graph.capture_end = timed_begin, timed_end
    try:
        torch.cuda.reset_peak_memory_stats()
        out, s_first, _ = solve(GC.grabcut_core, bgr, mask)
    finally:
        CPM.warm_up = warm
        graph.capture_begin, graph.capture_end = begin, end
    res = {"first_s": s_first, **acc,
           "rest_s": s_first - acc["warm_up_s"] - acc["capture_s"],
           "programs": len(GC.programs()),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "reserved_mib": torch.cuda.memory_reserved() / 2**20}
    warm_out, res["warm_s"], _ = solve(GC.grabcut_core, bgr, mask)
    eager, res["eager_s"], _ = solve(GC._grabcut_core_eager, bgr, mask)
    res["same_bytes"] = bool(np.array_equal(out, eager)
                             and np.array_equal(warm_out, eager))
    return res


def one_shot(sizes, against) -> dict:
    """The command line's GrabCut, one process a call, here and in the
    checkout `against`: each process's wall."""
    here = os.getcwd()
    trees = [here] if against is None else [os.path.abspath(against), here]
    order = trees + trees[::-1]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        def run(tree, name, flags):
            dst = os.path.join(tmp, f"{name}_{len(rows)}.png")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "image_segmenter_tpu_torch.cli",
                 os.path.join(tmp, f"{name}.png"), dst, *flags, "-q"],
                cwd=tree, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise SystemExit(f"profile_grabcut: the command line in "
                                 f"{tree} exits {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
            rows.append({"tree": "this" if tree == here else "against",
                         "size": name, "s": wall})
            return open(dst, "rb").read()

        for h, w in sizes:
            name = f"{h}x{w}"
            rgb = np.ascontiguousarray(portrait_scene(h, w, SEEDS[0])[0]
                                       [..., ::-1])
            with open(os.path.join(tmp, f"{name}.png"), "wb") as f:
                f.write(CLI._png_encode(rgb))
            rect = ",".join(map(str, config4_rect(h, w)))
            outs = {}
            for tree in order:
                outs.setdefault(tree, set()).add(
                    run(tree, name, ["--grabcut-rect", rect,
                                     "--no-simplify"]))
            if len(set().union(*outs.values())) != 1:
                raise SystemExit(f"profile_grabcut: {name}: the checkouts "
                                 "write other bytes")
        name = f"{sizes[0][0]}x{sizes[0][1]}"
        for tree in order:
            run(tree, name, ["--no-simplify"])
            rows[-1]["size"] = "no GrabCut"
    return {"rows": rows}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.profile_grabcut")
    ap.add_argument("hw", nargs="*", type=int, default=[1024, 768])
    ap.add_argument("--chunks", default=None,
                    help="sweep the cut's chunk, e.g. 10,25,50,100")
    ap.add_argument("--restart-chunks", default=None,
                    help="sweep the k-means restarts' chunk, e.g. 2,4,8")
    ap.add_argument("--first", action="store_true",
                    help="split the process's first compiled call")
    ap.add_argument("--one-shot", default=None,
                    help="the command line's GrabCut a process a call at "
                    "these sizes, e.g. 256x192,1024x768")
    ap.add_argument("--against", default=None,
                    help="with --one-shot: another checkout to compare")
    args = ap.parse_args(argv)
    h, w = args.hw
    if not torch.cuda.is_available():
        raise SystemExit("profile_grabcut needs a CUDA device")
    strict_f32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)

    if args.first:
        res = first_call(h, w)
        print(f"first compiled call {h}x{w}: {res['first_s']:.4f} s = "
              f"warm-ups {res['warm_up_s']:.4f} + captures "
              f"{res['capture_s']:.4f} ({res['graphs']} graphs of "
              f"{res['programs']} programs) + replays and glue "
              f"{res['rest_s']:.4f}; warm {res['warm_s']:.4f} s, eager "
              f"{res['eager_s']:.4f} s; peak {res['peak_mib']:.1f} MiB, "
              f"reserved {res['reserved_mib']:.1f} MiB; same bytes "
              f"{res['same_bytes']}")
        print(json.dumps({"first_call": f"{h}x{w}", "card": card, **res}))
        if not res["same_bytes"]:
            raise SystemExit("profile_grabcut: compiled and eager differ")
        return

    if args.one_shot:
        sizes = [tuple(int(n) for n in s.split("x"))
                 for s in args.one_shot.split(",")]
        res = one_shot(sizes, args.against)
        for r in res["rows"]:
            print(f"one-shot {r['size']} ({r['tree']}): {r['s']:.3f} s")
        print(json.dumps({"one_shot": args.one_shot, "card": card, **res}))
        return

    if args.chunks:
        res = sweep(h, w, [int(c) for c in args.chunks.split(",")])
        for r in res["rows"]:
            print(f"cut {r['cut']} chunk {r['chunk']}: {r['ms']:.3f} ms, "
                  f"{r['ms_per_iteration']:.4f} ms an iteration over "
                  f"{r['max_iters']}, {r['host_reads']} host reads")
        print(json.dumps({"sweep": "cp_chunk", "card": card, **res}))
        if not res["same_bits"]:
            raise SystemExit("profile_grabcut: the chunks gave other bits")
        return

    if args.restart_chunks:
        res = restart_sweep(h, w, [int(c) for c in
                                   args.restart_chunks.split(",")])
        for r in res["rows"]:
            print(f"restart chunk {r['chunk']}: warm {r['s']:.4f} s "
                  f"(first {r['first_s']:.4f}), t_init {r['t_init']:.4f}, "
                  f"t_polish {r['t_polish']:.4f}")
        print(json.dumps({"sweep": "restart_chunk", "card": card, **res}))
        if not res["same_bytes"]:
            raise SystemExit("profile_grabcut: the chunks gave other bytes")
        return

    mask = rect_mask(h, w)
    torch.cuda.reset_peak_memory_stats()
    for i, seed in enumerate(SEEDS):
        bgr, _ = portrait_scene(h, w, seed)
        first, s_first, _ = solve(GC.grabcut_core, bgr, mask)
        if i == 0:
            graphs = sum(p.graphs() for p in GC.programs())
            print(f"after the first call: {len(GC.programs())} programs, "
                  f"{graphs} graphs; device memory peak "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
                  f"reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB")
        warm, s_warm, info = solve(GC.grabcut_core, bgr, mask)
        eager, s_eager, e_info = solve(GC._grabcut_core_eager, bgr, mask)
        same = (np.array_equal(first, eager) and np.array_equal(warm, eager)
                and info["cut_iters"] == e_info["cut_iters"])
        print(f"{h}x{w} scene {seed}: compiled first {s_first:.4f} s, warm "
              f"{s_warm:.4f} s, eager {s_eager:.4f} s; equal bytes and cut "
              f"iterations {same}; compiled {_rounded(info)}; eager "
              f"{_rounded(e_info)}")

    bgr, _ = portrait_scene(h, w, SEEDS[0])
    acc, calls = collections.defaultdict(float), collections.Counter()
    undo = _instrument(acc, calls)
    try:
        _, wall, info = solve(GC._grabcut_core_eager, bgr, mask)
    finally:
        undo()
    print(f"wrapped eager {h}x{w} scene {SEEDS[0]}: {wall:.4f} s "
          f"{_rounded(info)}")
    for key in sorted(acc, key=lambda k: -acc[k]):
        print(f"  {key}: {acc[key]:.4f} s over {calls[key]} calls")

    _row(f"compiled call {h}x{w}", device_view(
        lambda: GC.grabcut_core(bgr, mask, iterations=10, device="cuda")))
    _row(f"eager call {h}x{w}", device_view(
        lambda: GC._grabcut_core_eager(bgr, mask, iterations=10,
                                       device="cuda")))

    g = torch.Generator(device="cuda").manual_seed(25)
    unary = torch.randn((1, h, w), generator=g, device="cuda") * 4
    wts = GC._nlink_weights(torch.rand((3, h, w), generator=g,
                                       device="cuda") * 255)
    free = torch.zeros((1, h, w), dtype=torch.bool, device="cuda")
    cut = (unary, wts, free, free)
    prog = Compiled(cut_program(100, GC.CP_CHUNK),
                    [(t.shape, t.dtype) for t in cut],
                    torch.device("cuda"))
    prog(*cut)
    drive(cut_program(100, GC.CP_CHUNK)(*cut))  # the eager warm-up
    _row(f"Chambolle-Pock loop, 100 iterations at 1x{h}x{w}, eager",
         device_view(lambda: drive(cut_program(100, GC.CP_CHUNK)(*cut))))
    _row(f"Chambolle-Pock loop, 100 iterations at 1x{h}x{w}, from a graph",
         device_view(lambda: prog(*cut)))


if __name__ == "__main__":
    main(sys.argv[1:])
