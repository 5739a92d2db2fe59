"""The chunk size of the compiled run's loops, swept.

    python -m image_segmenter_tpu_torch.bench.sweep_chunks \
        [--chunks 1,2,4,8,16] [--content photo,synthetic] [--reps R] \
        [--b B] [--h H] [--w W]

`Pipeline(model="u2netp", k=16).run` (on the card the compiled run,
pipeline/compiled.py) at 4 x 2160 x 3840 by default, on bench.py's photo
mosaic and its synthetic batch, for each chunk n: `solvers/matting.
CG_CHUNK` and `solvers/kmeans.LLOYD_CHUNK` both set to n, a fresh Pipeline
(a program of its own), one call that captures it, then `--reps` (5)
synchronised calls with the batch on the device, host clock. A row: the
median ms and the spread, the CG's and the Lloyd loop's largest
iteration count, K3's launches and the host reads of the stop flags in
one run (a loop reads its flag once a chunk it runs and once more to
stop). A chunk of n wastes up to n - 1 masked iterations of a loop and
saves the reads between them, so the rows give the time of a read
against the time of an iteration. Every n must give the same bytes; one
JSON line.

On the CPU (`main(argv, device="cpu")`, small shapes) `run` is eager and
reads the flags the same way.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import statistics
import sys

import torch

from image_segmenter_tpu_torch.bench.bench import launches_of, photo_batch, \
    synthetic_batch, timed_calls
from image_segmenter_tpu_torch.bench.micro_common import REPS, emit
from image_segmenter_tpu_torch.pipeline import segment as SEG
from image_segmenter_tpu_torch.pipeline.compiled import drive
from image_segmenter_tpu_torch.solvers import kmeans as KM
from image_segmenter_tpu_torch.solvers import matting as MAT
from image_segmenter_tpu_torch.utils.backend import resolve_device

CONTENT = {"photo": photo_batch, "synthetic": synthetic_batch}


def _sha(out) -> str:
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _iterations(pipe, x) -> list:
    """The largest iteration count of each loop in one run of `x`: from
    the compiled program's last call, or an eager run on the CPU."""
    if pipe.programs:
        (prog,) = pipe.programs.values()
        return [int(it.max()) for it in prog.iterations()]
    loops = []
    drive(SEG.batch_program(pipe.stages, pipe.session.module, x), loops)
    return [int(loop.it.max()) for loop in loops]


def sweep(dev, chunks, contents, b: int, h: int, w: int,
          reps: int = REPS) -> dict:
    rows, shas = [], {}
    saved = MAT.CG_CHUNK, KM.LLOYD_CHUNK
    try:
        for name in contents:
            x = torch.from_numpy(CONTENT[name](b, h, w)).to(dev)
            for n in chunks:
                MAT.CG_CHUNK = KM.LLOYD_CHUNK = n
                pipe = SEG.Pipeline(model="u2netp", k=16, device=dev)
                out, times = timed_calls(lambda: pipe.run(x), dev, reps)
                _, launches = launches_of(lambda: pipe.run(x), dev)
                its = _iterations(pipe, x)
                ms = [t * 1e3 for t in times]
                rows.append({
                    "content": name, "chunk": n, "ms": statistics.median(ms),
                    "min_ms": min(ms), "max_ms": max(ms),
                    "cg_iters": its[0], "lloyd_iters": its[1],
                    "k3_launches": launches["matvec"],
                    "host_reads": sum(-(-i // n) + 1 for i in its)})
                shas.setdefault(name, set()).add(_sha(out))
                del pipe, out
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    finally:
        MAT.CG_CHUNK, KM.LLOYD_CHUNK = saved
    return {"rows": rows, "same_bytes": all(len(s) == 1
                                            for s in shas.values())}


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_segmenter_tpu_torch.bench.sweep_chunks")
    ap.add_argument("--chunks", default="1,2,4,8,16")
    ap.add_argument("--content", default="photo,synthetic")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--h", type=int, default=2160)
    ap.add_argument("--w", type=int, default=3840)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    chunks = [int(c) for c in args.chunks.split(",")]
    contents = args.content.split(",")
    res = sweep(dev, chunks, contents, args.b, args.h, args.w, args.reps)
    emit("sweep_chunks", dev, {
        "shape": [args.b, args.h, args.w], "reps": args.reps,
        "timing": "median of synchronised calls, batch on the device, "
        "host clock", **res})
    if not res["same_bytes"]:
        raise SystemExit("sweep_chunks: the chunk sizes gave other bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
