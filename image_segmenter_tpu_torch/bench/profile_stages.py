"""Where one run of the main path spends its time, stage by stage.

    python -m image_segmenter_tpu_torch.bench.profile_stages [H W B reps]
        [--photo]

Counterpart of the JAX package's bench/profile_stages.py, on the port's
functions: `Pipeline(model="u2netp", k=16)` on bench.py's synthetic batch
(default 4 x 2160 x 3840; `--photo`: its photo mosaic, the headline's
content, a separate series), taken apart into the steps of
`pipeline/segment.make_stage_fns`, each fed the previous step's output:

    ingest (host -> device), the Lanczos resize to the network size, the
    CNN, the mask's Lanczos resize up, the AREA shrink to the matting
    size, the trimap, the matting CG (its iterations and K3 launches), the
    LINEAR resize up, Otsu and close/open, the colour sample, the k-means
    fit, the palette map, the full run op by op (`Pipeline.run_eager`,
    device-resident input) and the full run as `Pipeline.run` gives it,
    compiled on the card (CUDA graphs, pipeline/compiled.py; on the CPU
    the same eager run).

Each row is the host clock around synchronised calls: one warm call,
then the median of `reps`. sum(stages) is printed beside the eager full
run. The chained steps and the compiled run must give the eager full
run's bytes, or the program raises.

On the card each row also gets its device view from one call under
torch.profiler (`utils/profiling.capture_device_timeline`, the device
only): the ms at least one device operation ran (the union of their
intervals) and the count of device operations. For the full run also the
busy share and idle share against that call's wall (1 - union / wall)
and against the unprofiled full run's median (the profiler lengthens the
call it traces), the five largest device operations, and the main-path
kernels' launches (K1-K4) in one compiled run; the same shares and
operations for the compiled run (`compiled_*`). On the CPU these device
fields are null.

Prints the table on stderr and ends with one stdout JSON line holding it.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time

import torch

from image_segmenter_tpu_torch.bench.bench import card_label, launches_of, \
    photo_batch, synthetic_batch, sync, timed_calls
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.pipeline import segment as SEG
from image_segmenter_tpu_torch.utils import profiling as PROF
from image_segmenter_tpu_torch.utils.backend import resolve_device

REPS = 5
TOP_OPS = 5
FULL_RUN = "full run (device-resident input)"
COMPILED_RUN = "compiled run (device-resident input)"


def _log(msg: str) -> None:
    print(f"[profile_stages] {msg}", file=sys.stderr, flush=True)


def device_view(fn, dev) -> dict:
    """One call of fn under the profiler: its wall, the union of its
    device operations' intervals, their count and the largest ones.
    Empty on the CPU."""
    if dev.type != "cuda":
        return {}
    walls = []

    def call():
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        walls.append(time.perf_counter() - t0)
    ops, intervals = PROF.capture_device_timeline(call)
    return {"wall_ms": walls[0] * 1e3,
            "busy_ms": PROF.busy_us(intervals) / 1e3,
            "ops": len(intervals),
            "top": [{"name": n, "ms": t / 1e3, "count": c}
                    for n, t, c in ops[:TOP_OPS]]}


def profile(device="cuda", b: int = 4, h: int = 2160, w: int = 3840,
            reps: int = REPS, model: str = "u2netp",
            matting_dim=None, imgs=None) -> dict:
    """The stage table of one `Pipeline(model, k=16)` on `device`, on
    `imgs` ((b, h, w, 3) u8 numpy) or else bench.py's synthetic batch."""
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    dev = resolve_device(device)
    pipe = Pipeline(model=model, k=16, matting_dim=matting_dim, device=dev)
    spec = pipe.session.spec
    nh, nw = spec.size
    mean = torch.tensor(spec.mean, dtype=torch.float32, device=dev)
    std = torch.tensor(spec.std, dtype=torch.float32, device=dev)
    mdim, k = pipe.matting_dim, pipe.k
    shrink = h > mdim or w > mdim
    sh, sw = RZ.scale_to_max_dim(h, w, mdim) if shrink else (h, w)
    host = torch.from_numpy(synthetic_batch(b, h, w) if imgs is None
                            else imgs)
    if tuple(host.shape) != (b, h, w, 3):
        raise ValueError(f"profile: imgs {tuple(host.shape)} is not "
                         f"{(b, h, w, 3)}")
    rows = []

    def row(name, fn, **extra):
        out, times = timed_calls(fn, dev, reps)
        view = device_view(fn, dev)
        rows.append({"stage": name, "ms": statistics.median(times) * 1e3,
                     "ms_all": [t * 1e3 for t in times],
                     "device_busy_ms": view.get("busy_ms"),
                     "device_ops": view.get("ops"), **extra})
        return out, view

    (x, _) = row("ingest (host -> device)",
                 lambda: host.to(dev, copy=True))
    (small, _) = row(f"resize {h}x{w} -> {nh}x{nw} (Lanczos)",
                     lambda: RZ.resize_u8(x, (nh, nw), RZ.LANCZOS_PIL))
    (mask, _) = row(f"cnn {model} {nh}x{nw} b{b}",
                    lambda: SEG.saliency_u8(pipe.session.module, small,
                                            mean, std, spec.post))
    (alpha0, _) = row(f"mask {nh}x{nw} -> {h}x{w} (Lanczos)",
                      lambda: RZ.resize_u8(mask, (h, w), RZ.LANCZOS_PIL))

    def area():
        if not shrink:
            return x, alpha0
        return (RZ.resize_u8(x, (sh, sw), RZ.AREA),
                RZ.resize_u8(alpha0, (sh, sw), RZ.AREA))
    ((rgb_s, a_s), _) = row(f"AREA {h}x{w} -> {sh}x{sw}", area)
    (trimap, _) = row("trimap", lambda: SEG._trimap_device(a_s))
    (alpha_m, iters), _ = row(
        f"matting CG {sh}x{sw}",
        lambda: SEG.matting_solve_u8(rgb_s, trimap, a_s, pipe.cg_iters))
    _, solve_launches = launches_of(
        lambda: SEG.matting_solve_u8(rgb_s, trimap, a_s, pipe.cg_iters), dev)
    rows[-1].update(cg_iters=[int(i) for i in iters.cpu()],
                    k3_launches=solve_launches["matvec"])
    (alpha_full, _) = row(
        f"alpha {sh}x{sw} -> {h}x{w} (LINEAR)",
        lambda: RZ.resize_u8(alpha_m, (h, w), RZ.LINEAR) if shrink
        else alpha_m)
    (sharp, _) = row("Otsu + close/open", lambda: SEG._sharp_alpha(alpha_full))
    ((sample, wts, thr), _) = row(
        "colour sample", lambda: SEG._kmeans16_sample(x, sharp, k))
    (centers, _) = row(f"k-means fit k{k}",
                       lambda: SEG._kmeans16_fit(sample, wts, k))
    (qrgb, _) = row("palette map",
                    lambda: SEG._kmeans16_map(x, sharp, thr, centers, k))
    (full, view) = row(FULL_RUN, lambda: pipe.run_eager(x))
    full_ms = rows[-1]["ms"]
    (compiled, cview) = row(COMPILED_RUN, lambda: pipe.run(x))
    compiled_ms = rows[-1]["ms"]
    _, launches = launches_of(lambda: pipe.run(x), dev)

    alpha_out = sharp.to(torch.uint8) * 255
    chained = {"rgba": torch.cat([qrgb, alpha_out[..., None]], dim=-1),
               "alpha": alpha_full, "palettes": centers}
    for what, out in (("chained steps", chained),
                      ("compiled run", compiled._asdict())):
        differ = [n for n, t in out.items()
                  if not torch.equal(t, getattr(full, n))]
        if differ:
            raise RuntimeError(f"profile_stages: the {what}' {differ} "
                               "differ from the eager full run's")

    staged = sum(r["ms"] for r in rows[1:-2])
    busy_share, idle_share, idle_unprofiled = _shares(view, full_ms)
    c_busy, c_idle, c_idle_unprofiled = _shares(cview, compiled_ms)
    return {
        "shape": [b, h, w], "model": model, "device": str(dev),
        "card": card_label(dev), "reps": reps, "rows": rows,
        "sum_stages_ms": staged, "full_ms": full_ms,
        "attributed": staged / full_ms,
        "full_profiled_wall_ms": view.get("wall_ms"),
        "busy_share": busy_share,
        "idle_share": idle_share,
        # the same union against the unprofiled full run's median wall
        "idle_share_unprofiled": idle_unprofiled,
        "top_ops": view.get("top"),
        "compiled_ms": compiled_ms,
        "compiled_profiled_wall_ms": cview.get("wall_ms"),
        "compiled_busy_share": c_busy,
        "compiled_idle_share": c_idle,
        "compiled_idle_share_unprofiled": c_idle_unprofiled,
        "compiled_top_ops": cview.get("top"),
        "launches": launches,
    }


def _shares(view: dict, unprofiled_ms: float) -> tuple:
    """(busy share, idle share) against the profiled call's wall, and the
    idle share against the unprofiled run's median; Nones on the CPU."""
    if not view:
        return None, None, None
    busy = view["busy_ms"] / view["wall_ms"]
    return busy, 1.0 - busy, 1.0 - view["busy_ms"] / unprofiled_ms


def print_table(res: dict) -> None:
    for r in res["rows"]:
        dev = ("" if r["device_busy_ms"] is None else
               f"  device busy {r['device_busy_ms']:9.3f} ms, "
               f"{r['device_ops']:6d} ops")
        _log(f"{r['stage']:40s} {r['ms']:10.3f} ms{dev}")
        if "cg_iters" in r:
            _log(f"{'':40s} CG iterations {r['cg_iters']}, K3 launches "
                 f"{r['k3_launches']}")
    _log(f"sum(stages) = {res['sum_stages_ms']:.3f} ms  vs  eager full = "
         f"{res['full_ms']:.3f} ms ({res['attributed'] * 100:.1f} % "
         "attributed; ingest not in the sum); compiled "
         f"{res['compiled_ms']:.3f} ms")
    for name, p in (("eager full run", "full_"), ("compiled run", "compiled_")):
        q = "" if p == "full_" else p  # the eager run's shares are unprefixed
        if res[q + "busy_share"] is None:
            continue
        _log(f"{name} under the profiler: wall "
             f"{res[p + 'profiled_wall_ms']:.3f} ms, busy share "
             f"{res[q + 'busy_share']:.4f}, idle share "
             f"{res[q + 'idle_share']:.4f}; idle share against the "
             f"unprofiled {res[p + 'ms']:.3f} ms "
             f"{res[q + 'idle_share_unprofiled']:.4f}")
        for op in res[q + "top_ops"]:
            _log(f"  {op['ms']:9.3f} ms x{op['count']:5d}  {op['name'][:90]}")
    _log(f"main-path kernel launches in one run: {res['launches']} "
         f"({res['card']})")


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    photo = "--photo" in argv
    nums = [int(a) for a in argv if a != "--photo"][:4]
    defaults = [2160, 3840, 4, REPS]    # H W B reps
    h, w, b, reps = nums + defaults[len(nums):]
    with contextlib.redirect_stdout(sys.stderr):
        res = profile(device, b, h, w, reps,
                      imgs=photo_batch(b, h, w) if photo else None)
        res["content"] = "photo" if photo else "synthetic"
        print_table(res)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
