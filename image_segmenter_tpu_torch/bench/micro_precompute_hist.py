"""Microbench: K2 (the matting precompute) and K1 (the u8 histogram) at
the main path's shapes, through their public entry points only.

It calls `kernels.precompute.precompute_planes` and
`kernels.histogram.hist256` and nothing beneath them, so one copy of this
script times any tree of the package: to compare two trees on one card,
run it with PYTHONPATH set to each in turn, inside one call (parent,
change, change, parent).

Inputs, all from numpy's default_rng(seed):
- K2: a (4, 3, 576, 1024) float32 image, uniform in [0, 1);
- K1 "random": uniform bytes, (4, 8,294,400) and (4, 589,824), the sizes of
  the main path's Otsu and trimap histograms;
- K1 "alpha-like": an elliptic plane of 255 on 0, as a refined alpha, with
  8 % of its bytes, scattered, replaced by uniform random ones (so at
  least 90 % are 0 or 255 and few 16-byte pieces are of one value).

Per case three times in ms, medians of `REPS`: one call between two CUDA
events (holds the host's way to the launch), `LAUNCHES` calls back to
back between two events (holds the host's launch rate where the kernel
is shorter than a wrapper call), and the same calls replayed from a CUDA
graph (the device's time alone, every device operation of a call
included). K1 must equal np.bincount, K2 is held to its plain version
(largest min(abs, rel) error, and whether the bits are equal). The sha256
of each output lets two trees be compared byte for byte. With `pipeline`
as the second argument it instead runs `Pipeline(model="u2netp", k=16)` on
a seeded 4 x 2160 x 3840 batch and prints the sha256 of its three outputs.

    python -m image_segmenter_tpu_torch.bench.micro_precompute_hist [cuda|cpu] [pipeline]
"""

from __future__ import annotations

import hashlib
import statistics
import sys

import numpy as np
import torch

from image_segmenter_tpu_torch.bench.micro_quantize import median_ms
from image_segmenter_tpu_torch.kernels import histogram as K1
from image_segmenter_tpu_torch.kernels import precompute as K2
from image_segmenter_tpu_torch.utils.backend import resolve_device

LAUNCHES = 20   # back to back between two events, and in a graph
REPS = 10
K2_SHAPE = (4, 3, 576, 1024)
K1_ROWS, K1_LARGE, K1_SMALL = 4, 2160 * 3840, 576 * 1024
NOISE_SHARE = 0.08


def alpha_like(rows: int, n: int, rng) -> np.ndarray:
    """(rows, n) uint8: an ellipse of 255 on 0 over a plane of about 16:9,
    then `NOISE_SHARE` of the bytes, scattered, made uniform random."""
    w = max(1, int(round((n * 16 / 9) ** 0.5)))
    h = -(-n // w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((rows, n), np.uint8)
    for i in range(rows):
        r = np.hypot((yy - 0.5 * h) / ((0.25 + 0.05 * i) * h),
                     (xx - 0.5 * w) / (0.3 * w))
        out[i] = np.where(r < 1.0, 255, 0).astype(np.uint8).reshape(-1)[:n]
    noisy = rng.random((rows, n), dtype=np.float32) < NOISE_SHARE
    out[noisy] = rng.integers(0, 256, int(noisy.sum()), dtype=np.uint8)
    return out


def hist_inputs(seed: int = 0, large: int = K1_LARGE, small: int = K1_SMALL,
                rows: int = K1_ROWS) -> dict:
    """name -> (rows, n) uint8 numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        f"random {rows}x{large}": rng.integers(0, 256, (rows, large),
                                               dtype=np.uint8),
        f"alpha-like {rows}x{large}": alpha_like(rows, large, rng),
        f"random {rows}x{small}": rng.integers(0, 256, (rows, small),
                                               dtype=np.uint8),
        f"alpha-like {rows}x{small}": alpha_like(rows, small, rng),
    }


def graph_ms(fn, launches: int = LAUNCHES, reps: int = REPS) -> float:
    """ms per call of `launches` calls of `fn` captured into one CUDA graph
    and replayed: the device's time, the host out of the way."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


def _times(fn, on_card: bool) -> dict:
    return {"ms": median_ms(fn, on_card, REPS),
            "ms_back_to_back": median_ms(fn, on_card, REPS, LAUNCHES),
            "ms_graph": graph_ms(fn) if on_card else float("nan")}


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def run(device="cuda", k2_shape=K2_SHAPE, hist=None) -> list:
    """One row per case: {"kernel", "input", "ms", "ms_back_to_back",
    "ms_graph", "exact" or "err" and "bit_equal", "sha"}."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rows = []
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.random(k2_shape, dtype=np.float32)).to(dev)
    got = K2.precompute_planes(img, 1e-7)
    ref = K2.precompute_planes_plain(img, 1e-7)
    err = (got - ref).abs()
    err = float(torch.minimum(err, err / ref.abs().clamp_min(1e-30)).max())
    rows.append({"kernel": "K2 precompute_planes",
                 "input": "x".join(map(str, k2_shape)), "err": err,
                 "bit_equal": bool(torch.equal(got, ref)), "sha": _sha(got),
                 **_times(lambda: K2.precompute_planes(img, 1e-7), on_card)})
    for name, xh in (hist_inputs() if hist is None else hist).items():
        x = torch.from_numpy(xh).to(dev)
        ref = np.stack([np.bincount(r, minlength=256) for r in xh])
        got = K1.hist256(x)
        rows.append({"kernel": "K1 hist256", "input": name,
                     "exact": bool(np.array_equal(got.cpu().numpy(),
                                                  ref.astype(np.float32))),
                     "sha": _sha(got),
                     **_times(lambda: K1.hist256(x), on_card)})
    return rows


def photo_batch(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients + sensor-like noise, phase-shifted per image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w, 3), np.uint8)
    for i in range(b):
        s = 17.0 * i
        base = np.stack([
            127 + 100 * np.sin((xx + s) / 97.0) * np.cos(yy / 53.0),
            127 + 100 * np.cos((xx - s) / 131.0),
            127 + 100 * np.sin((xx + yy + s) / 173.0),
        ], axis=-1)
        noise = rng.standard_normal((h, w, 3), dtype=np.float32) * 6.0
        out[i] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return out


def pipeline_hashes(device="cuda", b: int = 4, h: int = 2160,
                    w: int = 3840) -> dict:
    """sha256 of the main path's outputs on a seeded batch."""
    from image_segmenter_tpu_torch.pipeline.segment import Pipeline

    pipe = Pipeline(model="u2netp", k=16, device=device)
    out = pipe.run(photo_batch(b, h, w, seed=0))
    return {name: _sha(t) for name, t in zip(out._fields, out)}


def main(argv) -> None:
    device = argv[1] if len(argv) > 1 else "cuda"
    if len(argv) > 2 and argv[2] == "pipeline":
        print(f"[micro_precompute_hist] Pipeline 4x2160x3840 sha256: "
              f"{pipeline_hashes(device)}", flush=True)
        return
    res = run(device)
    for row in res:
        check = f"exact {row['exact']}" if "exact" in row else \
            f"err {row['err']:.3g} bit-equal {row['bit_equal']}"
        print(f"[micro_precompute_hist] {row['kernel']:22s} {row['input']:22s} "
              f"one launch {row['ms']:.4f} ms, back to back "
              f"{row['ms_back_to_back']:.4f}, graph {row['ms_graph']:.4f}; "
              f"{check}; sha {row['sha']}", flush=True)
    if not all(row.get("exact", True) and row.get("err", 0.0) < 1e-4
               for row in res):
        raise SystemExit("a kernel differs from its reference")


if __name__ == "__main__":
    main(sys.argv)
