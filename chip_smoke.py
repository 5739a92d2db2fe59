"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each raising (and exiting non-zero) on failure:
1. card: CUDA must be present; prints the card name and power limit;
2. build: compiles the eight CUDA kernels from kernels/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes and at ragged shapes, with warm timings, its bound
   (the least time the card could take: bytes over the memory rate or
   operations over the float32 rate, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time; K5 and K6
   also against K3's output on the same operands, K7 against K4's, every
   variant of K8 against K1's;
4. slice: Pipeline(model="u2netp", k=16).run on a seeded 4 x 2160 x 3840
   photo-like batch, with output checks, per-kernel launch counts, and a
   bit-identical second run;
5. card against CPU: the same pipeline and weights on a 720 x 1280 image
   on the card and on the CPU (plain path), end to end, and the matting
   and quantize stages from the same CNN mask on both;
6. matvec variants: bench/micro_matvec.run at 4 x 576 x 1024, the path
   that launches K5 and K6: ms per matvec of the plain formulation, K3,
   K5 and K6 over 50 fed-back matvecs, and each one's drift;
7. compat path on a seeded 1536 x 2048 frame: rembg_remove_bgr_to_rgba
   with the full U^2-Net, refine_alpha_portrait from the CNN's alpha (a
   meaningless mask from seeded weights: every rung capped at 400
   iterations) and from a synthetic soft-edged alpha with strokes (the
   float32 solve and the float64 polish must answer, on the card), the
   full-resolution refine, and the synthetic case at 384 x 512 on the
   card and the CPU;
8. quantize and histogram variants: bench/micro_quantize.run (K4 against
   K7 at 4 x 2160 x 3840, bit-equal) and bench/micro_hist_nibble.run (every
   variant of K8 and K1, exact against np.bincount), the paths that launch
   K7 and K8;
9. the colour quantizers of compat/color_simplify on photo-like RGBA with
   a transparent and a dark region: kmeans at 1024 x 1024, the classical
   batch at 1080 x 1920, the perceptual family at 2160 x 3840; output
   checks, a second call with the same bytes, warm times with the stage
   stamps, and card against CPU on a 270 x 480 frame.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from image_segmenter_tpu_torch.bench import micro_hist_nibble as BENCH_HIST
from image_segmenter_tpu_torch.bench import micro_matvec as BENCH
from image_segmenter_tpu_torch.bench import micro_quantize as BENCH_QUANT
from image_segmenter_tpu_torch.compat import _perceptual as PERCEPTUAL
from image_segmenter_tpu_torch.compat import color_simplify as CS
from image_segmenter_tpu_torch.compat import matting_refine as REFINE
from image_segmenter_tpu_torch.compat import rembg_infer as REMBG
from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels import hist_variants as K8
from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matting as K6
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ
from image_segmenter_tpu_torch.kernels import quantize_flat as K7
from image_segmenter_tpu_torch.pipeline.segment import Pipeline
from image_segmenter_tpu_torch.solvers import matting as MAT
from image_segmenter_tpu_torch.utils.backend import strict_f32

BATCH, H4K, W4K = 4, 2160, 3840
MH, MW = 576, 1024          # matting size of a 2160 x 3840 frame
RAGGED = (37, 53)
MATVEC_SHAPES = [(BATCH, MH, MW), (2, *RAGGED), (1, 33, 130)]
CARD_VS_CPU = (1, 720, 1280)  # over matting_dim: the AREA shrink path runs
COMPAT_HW = (1536, 2048)      # the compat path's frame (shrunk to 768 x 1024)
COMPAT_SMALL_HW = (384, 512)  # card against CPU
SEEDED_REFINE_CAP = 400       # CG iterations a rung may take on the seeded mask
QUANT_SMALL_HW = (270, 480)   # the quantizers, card against CPU
REPS = 10
INNER = 50                    # fed-back matvecs in the variant bench

# Published peaks of one H100 SXM: device memory 3.35 TB/s; float32
# outside the tensor cores 67 TFLOP/s (int32 adds are counted at that rate)
HBM_BPS = 3.35e12
F32_OPS = 67e12

_CSRC = "image_segmenter_tpu_torch/kernels/csrc/"
_TPU = "image_segmenter_tpu/kernels/"
KERNELS = {  # name -> (module, launch counter, source, TPU kernel's pallas_call)
    "histogram": (KH, "LAUNCHES", _CSRC + "histogram.cu",
                  _TPU + "pallas_histogram.py:117"),
    "precompute": (KP, "LAUNCHES", _CSRC + "precompute.cu",
                   _TPU + "pallas_precompute.py:206"),
    "matvec": (KMV, "LAUNCHES", _CSRC + "matvec.cu",
               _TPU + "pallas_matvec.py:271"),
    "quantize": (KQ, "LAUNCHES", _CSRC + "quantize.cu",
                 _TPU + "pallas_quantize.py:112"),
    "matvec_stack": (KMV, "STACK_LAUNCHES", _CSRC + "matvec_stack.cu",
                     _TPU + "pallas_matvec.py:225"),
    "matvec_recompute": (K6, "LAUNCHES", _CSRC + "matvec_recompute.cu",
                         _TPU + "pallas_matting.py:171"),
    "quantize_flat": (K7, "LAUNCHES", _CSRC + "quantize_flat.cu",
                      "bench/micro_quantize.py:63"),
    "hist_variants": (K8, "LAUNCHES", _CSRC + "hist_variants.cu",
                      "bench/micro_hist_nibble.py:93"),
}
MAIN_PATH = ("histogram", "precompute", "matvec", "quantize")
VARIANT_PATH = ("matvec_stack", "matvec_recompute")
MICRO_PATH = ("quantize_flat", "hist_variants")


def zero_counts() -> None:
    for mod, attr, _, _ in KERNELS.values():
        setattr(mod, attr, 0)
    K8.VARIANT_LAUNCHES.update(dict.fromkeys(K8.VARIANT_LAUNCHES, 0))


def read_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr, _, _) in KERNELS.items()}


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the operations
    at the float32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / F32_OPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = REPS) -> float:
    """Median of `reps` warm runs, each timed with CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def photo_batch(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Smooth gradients + sensor-like noise (bench.py's synthetic recipe),
    phase-shifted per image so the images differ."""
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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_histogram(label: str, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 256, (BATCH, H4K * W4K), generator=g,
                      dtype=torch.uint8, device=dev)
    x[0, :1 << 20] = 255  # a long run of one value: worst-case contention
    cases = {"main": x, "ragged": x[:2, :RAGGED[0] * RAGGED[1]].contiguous(),
             "unaligned": x[1, 1:].reshape(1, -1)}
    err = 0.0
    for name, xi in cases.items():
        got = KH.hist256(xi)
        ref = KH.hist256_plain(xi)
        if not torch.equal(got, ref):
            fail(f"histogram {name} {tuple(xi.shape)} differs from plain")
        err = max(err, float((got - ref).abs().max()))
    ms = median_ms(lambda: KH.hist256(x))
    plain_ms = median_ms(lambda: KH.hist256_plain(x))

    # the one PyTorch call that computes the same function: bincount on
    # values offset by 256 per row (the conversion it needs is timed too)
    offs = (torch.arange(x.shape[0], device=dev) * 256)[:, None]

    def library():
        return torch.bincount((x.to(torch.int64) + offs).flatten(),
                              minlength=256 * x.shape[0]).reshape(-1, 256)

    if not torch.equal(library().to(ref.dtype), KH.hist256_plain(x)):
        fail("histogram: the bincount yardstick differs from plain")
    library_ms = median_ms(library)
    # x read once, (B, 256) int32 written; one increment per element
    bd = bound(x.numel() + x.shape[0] * 256 * 4, x.numel())
    print(f"[kernels] histogram {tuple(x.shape)} u8: exact; kernel {ms:.4f} ms,"
          f" plain {plain_ms:.4f} ms, bincount {library_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({label})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": library_ms}


def _precompute_err(got, ref) -> float:
    """Largest per-entry min(|diff|, |diff| / |ref|)."""
    err = (got - ref).abs()
    rel = err / ref.abs().clamp_min(1e-30)
    return float(torch.minimum(err, rel).max())


def check_precompute(label: str, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(2)
    err_main = None
    for shape in [(BATCH, 3, MH, MW), (2, 3, *RAGGED)]:
        img = torch.rand(shape, generator=g, device=dev)
        got = KP.precompute_planes(img, 1e-7)
        ref = KP.precompute_planes_plain(img, 1e-7)
        e = _precompute_err(got, ref)
        if not e < 1e-4:
            fail(f"precompute {shape}: min(abs, rel) error {e} >= 1e-4")
        if err_main is None:
            err_main = float((got - ref).abs().max())
            main_img = img
    ms = median_ms(lambda: KP.precompute_planes(main_img, 1e-7))
    plain_ms = median_ms(lambda: KP.precompute_planes_plain(main_img, 1e-7))
    # 3 image planes read, 12 planes written. Operations per pixel: the
    # count and mean boxes and their division (19), pass A (9 shifts x 16),
    # pass B (9 x 16), pass C (9 x 15), the diag member sum (9 x 23), the
    # pivots, inverse entries and flag (about 45): about 690.
    px = BATCH * MH * MW
    bd = bound(15 * px * 4, 690 * px)
    print(f"[kernels] precompute (4, 3, {MH}, {MW}) f32: within 1e-4, "
          f"max|diff| {err_main:.3g}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None}


# Operations per pixel of one L @ p: the box of p and its division (5),
# the covariance (9 shifts x 3 channels x 3), the division and the packed
# solve (20), b (6), four member boxes (16), the output (8): about 135.
# K6 adds the count, three means and pbar rebuilt from 9 shifts each and
# takes its boxes in 9 adds instead of 4: about 215.
MATVEC_OPS, RECOMPUTE_OPS = 135, 215


def _matvec_operands(g, dev, b, h, w):
    img = torch.rand((b, 3, h, w), generator=g, device=dev)
    planes = KP.precompute_planes(img, 1e-7)
    p = torch.randn((b, h, w), generator=g, device=dev)
    return img, planes, p


def _rel_err(got, ref, scale=None) -> float:
    scale = ref.abs().max() if scale is None else scale
    return float((got - ref).abs().max() / (scale + 1e-9))


def check_matvec(label: str, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(3)
    err_main = None
    for b, h, w in MATVEC_SHAPES:
        img, planes, p = _matvec_operands(g, dev, b, h, w)
        got = KMV.matvec_planes(planes, img, p)
        ref = KMV.matvec_planes_plain(planes, img, p)
        e = _rel_err(got, ref)
        if not e < 1e-5:
            fail(f"matvec {(b, h, w)}: max|diff|/max|ref| {e} >= 1e-5")
        if err_main is None:
            err_main = float((got - ref).abs().max())
            args = (planes, img, p)
    ms = median_ms(lambda: KMV.matvec_planes(*args))
    plain_ms = median_ms(lambda: KMV.matvec_planes_plain(*args))
    # 10 of K2's planes, 3 image planes and p read, one plane written
    px = BATCH * MH * MW
    bd = bound(15 * px * 4, MATVEC_OPS * px)
    print(f"[kernels] matvec (4, {MH}, {MW}) f32: within 1e-5 of max|ref|, "
          f"max|diff| {err_main:.3g}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None}


def check_matvec_stack(label: str, dev) -> dict:
    """K5 against its plain version and against K3 on the same operands."""
    g = torch.Generator(device=dev).manual_seed(5)
    err_main = None
    for b, h, w in MATVEC_SHAPES:
        img, planes, p = _matvec_operands(g, dev, b, h, w)
        stack = KMV.build_matvec_stack_planes(img, planes)
        if not torch.equal(stack, KMV.build_matvec_stack(
                img, planes[:, 7], planes[:, 8:11], planes[:, 0:6])):
            fail(f"matvec_stack {(b, h, w)}: the two stack builders differ")
        got = KMV.matvec_stack(stack, p)
        ref = KMV.matvec_stack_plain(stack, p)
        k3 = KMV.matvec_planes(planes, img, p)
        e, e3 = _rel_err(got, ref), _rel_err(got, k3)
        if not (e < 1e-5 and e3 < 1e-5):
            fail(f"matvec_stack {(b, h, w)}: max|diff|/max|ref| {e} against "
                 f"plain, {e3} against K3 (bound 1e-5)")
        if err_main is None:
            err_main = float((got - ref).abs().max())
            same_bits = torch.equal(got, k3)
            args = (stack, p)
    ms = median_ms(lambda: KMV.matvec_stack(*args))
    plain_ms = median_ms(lambda: KMV.matvec_stack_plain(*args))
    # the least the function must move: the 13 planes at the image and
    # its halo of 2 and p read, one plane written. The stack's padding to
    # rows of 32 + 8 and columns of 128 is layout, never needed, so it is
    # left out of the bound
    px = BATCH * MH * MW
    halo_px = BATCH * (MH + 4) * (MW + 4)
    bd = bound((13 * halo_px + 2 * px) * 4, MATVEC_OPS * px)
    print(f"[kernels] matvec_stack (4, 13, {args[0].shape[2]}, "
          f"{args[0].shape[3]}) f32: within 1e-5 of max|ref| of plain and of "
          f"K3, max|diff| {err_main:.3g}, bit-equal to K3: {same_bits}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None}


def check_matvec_recompute(label: str, dev) -> dict:
    """K6 against its plain version (its whole output) and against K3's
    matvec inside the image."""
    g = torch.Generator(device=dev).manual_seed(6)
    err_main = None
    for b, h, w in MATVEC_SHAPES:
        img, planes, p = _matvec_operands(g, dev, b, h, w)
        static = K6.pack_static(torch.ones_like(p), img, planes[:, 0:6])
        p_pad = K6.pad_p(p)
        got = K6.matvec_planes(p_pad, static)
        ref = K6.matvec_planes_plain(p_pad, static)
        k3 = KMV.matvec_planes(planes, img, p)
        scale = k3.abs().max()
        e = _rel_err(got, ref, scale)
        e3 = _rel_err(got[:, :h, :w], k3, scale)
        if not (e < 1e-5 and e3 < 1e-5):
            fail(f"matvec_recompute {(b, h, w)}: max|diff|/max|ref| {e} "
                 f"against plain, {e3} against K3 (bound 1e-5)")
        if err_main is None:
            err_main = float((got - ref).abs().max())
            err_k3 = e3
            args = (p_pad, static)
    ms = median_ms(lambda: K6.matvec_planes(*args))
    plain_ms = median_ms(lambda: K6.matvec_planes_plain(*args))
    # the least the function must move: 10 static planes and p at the
    # image and its halo of 2 read (the zero columns beyond W + 4 are
    # layout), and the (rows of 32, padded width) output its contract
    # writes
    px = BATCH * MH * MW
    halo_px = BATCH * (MH + 4) * (MW + 4)
    out_px = BATCH * K6._out_rows(args[0].shape[1]) * args[0].shape[2]
    bd = bound((11 * halo_px + out_px) * 4, RECOMPUTE_OPS * px)
    print(f"[kernels] matvec_recompute (4, 10, {args[1].shape[2]}, "
          f"{args[1].shape[3]}) f32: within 1e-5 of max|ref| of plain and of "
          f"K3 ({err_k3:.3g}), max|diff| {err_main:.3g}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None}


def check_quantize(label: str, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for b, h, w, k_real in [(BATCH, H4K, W4K, 16), (2, *RAGGED, 11)]:
        rgb = torch.randint(0, 256, (b, h, w, 3), generator=g,
                            dtype=torch.uint8, device=dev)
        alpha = torch.rand((b, h, w), generator=g, device=dev) > 0.3
        pal = torch.randint(0, 256, (b, 16, 3), generator=g,
                            device=dev).to(torch.float32)
        pal[:, 5] = pal[:, 2]  # exact ties: the first index must win
        thr = torch.tensor([30.0, 10.0, -1.0, 30.0][:b], device=dev)
        got = KQ.quantize_map(rgb, alpha, pal, k_real, thr)
        ref = KQ.quantize_map_plain(rgb, alpha, pal, k_real, thr)
        if not torch.equal(got, ref):
            fail(f"quantize {(b, h, w)} differs from plain")
        if h == H4K:
            args = (rgb, alpha, pal, k_real, thr)
    ms = median_ms(lambda: KQ.quantize_map(*args))
    plain_ms = median_ms(lambda: KQ.quantize_map_plain(*args))
    # 3 + 1 bytes read and 3 written per pixel, plus the palettes. Per
    # pixel and palette entry 3 subtractions, 3 multiplications, 2
    # additions and a comparison (9 x 16), plus the brightness test (8)
    px = BATCH * H4K * W4K
    bd = bound(7 * px + BATCH * 16 * 3 * 4, (9 * 16 + 8) * px)
    print(f"[kernels] quantize (4, {H4K}, {W4K}, 3) u8 k=16: bit-exact; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} "
          f"ms by {bd['bound_by']} ({label})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None}


def check_quantize_flat(label: str, dev) -> dict:
    """K7 against its plain version and against K4 on the same operands:
    the bench shape, a ragged one (the byte path) and a small one whose
    rows are a multiple of 16 (the 16-byte path)."""
    g = torch.Generator(device=dev).manual_seed(7)
    for b, h, w, k_real in [(BATCH, H4K, W4K, 16), (2, *RAGGED, 11),
                            (3, 48, 50, 16)]:
        rgb = torch.randint(0, 256, (b, h, w, 3), generator=g,
                            dtype=torch.uint8, device=dev)
        alpha = torch.rand((b, h, w), generator=g, device=dev) > 0.3
        pal = torch.randint(0, 256, (b, 16, 3), generator=g,
                            device=dev).to(torch.float32)
        pal[:, 5] = pal[:, 2]  # exact ties: the first index must win
        thr = torch.tensor([30.0, 10.0, -1.0, 30.0][:b], device=dev)
        got = K7.quantize_map_flat(rgb, alpha, pal, k_real, thr)
        if not torch.equal(got, K7.quantize_map_flat_plain(rgb, alpha, pal,
                                                           k_real, thr)):
            fail(f"quantize_flat {(b, h, w)} differs from plain")
        if not torch.equal(got, KQ.quantize_map(rgb, alpha, pal, k_real, thr)):
            fail(f"quantize_flat {(b, h, w)} differs from K4")
        if h == H4K:
            planes = K7.split_planes(rgb)
            args = (planes, alpha.reshape(b, h * w), pal, k_real, thr)
            whole = (rgb, alpha, pal, k_real, thr)
    ms = median_ms(lambda: K7.quantize_planes(*args))
    plain_ms = median_ms(lambda: K7.quantize_planes_plain(*args))
    function_ms = median_ms(lambda: K7.quantize_map_flat(*whole))
    # K4's work: 3 + 1 bytes read and 3 written per pixel, 9 operations
    # per pixel and palette entry and 8 for the brightness test
    px = BATCH * H4K * W4K
    bd = bound(7 * px + BATCH * 16 * 3 * 4, (9 * 16 + 8) * px)
    print(f"[kernels] quantize_flat planes (3, 4, {H4K * W4K}) u8 k=16: "
          f"bit-equal to plain and to K4; kernel {ms:.4f} ms, with the split "
          f"into planes and the stack back {function_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({label})")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None, "function_ms": function_ms}


def check_hist_variants(label: str, dev) -> dict:
    """Every variant of K8 against its plain version, K1 and bincount."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randint(0, 256, (BATCH, H4K * W4K), generator=g,
                      dtype=torch.uint8, device=dev)
    x[0, :1 << 20] = 255  # a long run of one value
    cases = {"main": x, "ragged": x[:2, :RAGGED[0] * RAGGED[1]].contiguous(),
             "unaligned": x[1, 1:].reshape(1, -1), "one row": x[:1]}
    offs = (torch.arange(x.shape[0], device=dev) * 256)[:, None]

    def library():
        return torch.bincount((x.to(torch.int64) + offs).flatten(),
                              minlength=256 * x.shape[0]).reshape(-1, 256)

    ref_lib = library().to(torch.float32)
    per_variant = {}
    for variant in K8.STEPS:
        for name, xi in cases.items():
            got = K8.hist_variant(xi, variant)
            if name != "main":  # the plain one-hot products at full size once
                if not torch.equal(got, K8.hist_variant_plain(xi, variant)):
                    fail(f"hist_variants {variant} {name} differs from plain")
            if not torch.equal(got, KH.hist256(xi)):
                fail(f"hist_variants {variant} {name} differs from K1")
        if not torch.equal(K8.hist_variant(x, variant), ref_lib):
            fail(f"hist_variants {variant} differs from bincount")
        per_variant[variant] = {
            "ms": median_ms(lambda: K8.hist_variant(x, variant)),
            "ms_one_row": median_ms(lambda: K8.hist_variant(x[:1], variant))}
    if not torch.equal(K8.hist_variant_plain(x, "N3D"), ref_lib):
        fail("hist_variants: the plain version differs from bincount")
    plain_ms = median_ms(lambda: K8.hist_variant_plain(x, "N3D"), reps=3)
    library_ms = median_ms(library)
    k1_ms = median_ms(lambda: KH.hist256(x))
    bd = bound(x.numel() + x.shape[0] * 256 * 4, x.numel())
    bd1 = bound(x.shape[1] + 256 * 4, x.shape[1])
    for variant, t in per_variant.items():
        print(f"[kernels] hist_variants {variant} {tuple(x.shape)} u8: exact "
              f"against plain, K1 and bincount; kernel {t['ms']:.4f} ms (bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}), one row "
              f"{t['ms_one_row']:.4f} ms (bound {bd1['bound_ms']:.4f} ms) "
              f"({label})")
    print(f"[kernels] hist_variants: K1 on the same rows {k1_ms:.4f} ms, plain "
          f"(N3D) {plain_ms:.4f} ms, bincount {library_ms:.4f} ms ({label})")
    return {"max_abs_err": 0.0, "ms": per_variant["N3D"]["ms"],
            "plain_ms": plain_ms, **bd, "library_ms": library_ms,
            "variants": per_variant}


# ---------------------------------------------------------------------------
# phase 4 and 5: the slice
# ---------------------------------------------------------------------------

def check_output(out, k: int, b: int, h: int, w: int) -> None:
    rgba, alpha, pal = out
    if (tuple(rgba.shape) != (b, h, w, 4) or tuple(alpha.shape) != (b, h, w)
            or tuple(pal.shape) != (b, k, 3)):
        fail(f"output shapes {tuple(rgba.shape)} {tuple(alpha.shape)} "
             f"{tuple(pal.shape)}")
    if {rgba.dtype, alpha.dtype, pal.dtype} != {torch.uint8}:
        fail("outputs are not uint8")
    a = rgba[..., 3]
    if not bool(((a == 0) | (a == 255)).all()):
        fail("rgba alpha is not in {0, 255}")
    for i in range(b):
        opaque = rgba[i][a[i] > 0][:, :3].to(torch.int32)
        codes = torch.unique((opaque[:, 0] << 16) | (opaque[:, 1] << 8)
                             | opaque[:, 2])
        p = pal[i].to(torch.int32)
        allowed = torch.cat([(p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2],
                             torch.zeros(1, dtype=torch.int32,
                                         device=p.device)])
        if not bool(torch.isin(codes, allowed).all()):
            fail(f"image {i}: an opaque colour is not in its palette")


def run_slice(label: str) -> dict:
    imgs = photo_batch(BATCH, H4K, W4K, seed=0)
    pipe = Pipeline(model="u2netp", k=16, device="cuda")
    x = torch.from_numpy(imgs).to("cuda")
    pipe.run(x)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    zero_counts()
    out = pipe.run(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if k in MAIN_PATH}
    print(f"[slice] kernel launches in one Pipeline.run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the main path")

    check_output(out, 16, BATCH, H4K, W4K)
    again = pipe.run(x)
    for a, b in zip(out, again):
        if not torch.equal(a, b):
            fail("a second run is not bit-identical")

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.run(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    mp = BATCH * H4K * W4K / 1e6
    print(f"[slice] Pipeline(u2netp, k=16) {BATCH}x{H4K}x{W4K}: outputs ok, "
          f"second run bit-identical; warm {wall * 1e3:.3f} ms/batch "
          f"(median of {len(walls)}: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in walls)}), "
          f"{mp / wall:.3f} MP/s device-resident ({label})")

    # stage breakdown (host clock around synchronised stages)
    st = pipe.stages
    mv0 = KMV.LAUNCHES
    t = [time.perf_counter()]
    m = st.cnn(pipe.session.module, x)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    sharp, _ = st.matting(x, m)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    st.quantize(x, sharp)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    print(f"[slice] stages ms: cnn {(t[1] - t[0]) * 1e3:.3f}, matting "
          f"{(t[2] - t[1]) * 1e3:.3f} ({KMV.LAUNCHES - mv0} matvec launches), "
          f"quantize {(t[3] - t[2]) * 1e3:.3f} ({label})")
    return launches


def card_vs_cpu(label: str) -> None:
    """The same pipeline and seeded weights on the card and on the CPU.

    The CNN's bfloat16 convolutions round differently in cuDNN and in the
    CPU library, so the u8 saliency differs by a step or two in places and
    the full runs are held to an agreement of the output alpha, not to
    bits. Everything after the CNN rounds the same on both devices (the
    kernels equal their plain versions, divisions by a scalar are true
    divisions, and the sums that float32 would round by library order
    accumulate in float64 or run in a fixed order), so from the card's
    CNN mask the matting and quantize stages
    must give identical alpha, masks, RGBA and palettes on both.
    """
    b, h, w = CARD_VS_CPU
    img = photo_batch(b, h, w, seed=1)
    pipes = {dev: Pipeline(model="u2netp", k=16, device=dev)
             for dev in ("cuda", "cpu")}
    outs = {dev: [t.cpu() for t in pipe.run(img)]
            for dev, pipe in pipes.items()}
    (g_rgba, g_alpha, g_pal), (c_rgba, c_alpha, c_pal) = outs["cuda"], outs["cpu"]
    agree = float((g_rgba[..., 3] == c_rgba[..., 3]).double().mean())
    refined = float((g_alpha == c_alpha).double().mean())
    print(f"[card-vs-cpu] Pipeline {b}x{h}x{w}: rgba alpha agreement "
          f"{agree:.6f}; refined u8 alpha exact {refined:.6f}; palettes "
          f"identical: {bool(torch.equal(g_pal, c_pal))} ({label})")
    if agree < 0.99:
        fail(f"card-vs-CPU alpha agreement {agree} < 0.99")

    x = torch.from_numpy(img)
    card = pipes["cuda"]
    mask = card.stages.cnn(card.session.module, x.to("cuda")).cpu()
    res = {}
    for dev, pipe in pipes.items():
        sharp, alpha = pipe.stages.matting(x.to(dev), mask.to(dev))
        rgba, pal = pipe.stages.quantize(x.to(dev), sharp)
        res[dev] = [t.cpu() for t in (alpha, sharp, rgba, pal)]
    same = {name: torch.equal(g, c) for name, g, c in
            zip(("alpha", "sharp", "rgba", "palettes"), res["cuda"], res["cpu"])}
    print(f"[card-vs-cpu] matting + quantize from the card's CNN mask, "
          f"identical on card and CPU: {same}")
    if not all(same.values()):
        fail(f"card and CPU stages differ from the same CNN mask: {same}")


# ---------------------------------------------------------------------------
# phase 6: the matvec variant bench, the path that launches K5 and K6
# ---------------------------------------------------------------------------

def run_variants(label: str) -> dict:
    zero_counts()
    rows = BENCH.run("cuda", BATCH, MH, MW, inner=INNER)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if k in VARIANT_PATH}
    for row in rows:
        print(f"[variants] {row['name']:20s} {BATCH}x{MH}x{MW}: "
              f"{row['ms_per_matvec']:.4f} ms/matvec over {INNER} fed-back "
              f"matvecs, drift against the plain loop {row['drift']:.3g} "
              f"({label})")
        if not (np.isfinite(row["ms_per_matvec"]) and row["drift"] < 1e-5):
            fail(f"variant {row['name']}: drift {row['drift']} >= 1e-5")
    print(f"[variants] kernel launches in one bench run: {launches}")
    for name, n in launches.items():
        if n < INNER:
            fail(f"kernel {name} was launched {n} times by the variant "
                 f"bench, fewer than its {INNER} matvecs")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the compat path
# ---------------------------------------------------------------------------

def compat_case(h: int, w: int, seed: int):
    """A seeded photo-like frame with an elliptic subject, a soft-edged
    alpha for it as a segmentation net would give, and two strokes."""
    a, b = photo_batch(2, h, w, seed).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = np.hypot((yy - 0.5 * h) / (0.32 * h), (xx - 0.5 * w) / (0.28 * w))
    soft = np.clip((1.0 - r) * (0.04 * min(h, w)) + 0.5, 0.0, 1.0)
    frame = soft[..., None] * (0.6 * a + 90.0) + (1 - soft[..., None]) * 0.7 * b
    rgb = np.clip(frame, 0, 255).astype(np.uint8)
    alpha = np.clip(np.floor(soft * 255.0 + 0.5), 0, 255).astype(np.uint8)
    user = np.zeros((h, w), np.uint8)
    user[int(0.48 * h):int(0.52 * h), int(0.45 * w):int(0.55 * w)] = 1
    user[int(0.02 * h):int(0.04 * h), int(0.05 * w):int(0.40 * w)] = 2
    return rgb, alpha, user


class RungRecorder:
    """Wraps compat.matting_refine's estimate_alpha_cf to note which rungs
    of the ladder ran and which one answered."""

    def __init__(self, max_iter=None):
        """max_iter caps the CG iterations of every rung (cg_kwargs)."""
        self.calls = []
        self.max_iter = max_iter
        self._inner = REFINE.estimate_alpha_cf

    def __call__(self, image01, trimap, **kw):
        name = ("x64" if kw.get("x64") else
                "eps1e-6" if kw.get("laplacian_kwargs") else "basic")
        self.calls.append(name)
        if self.max_iter is not None:
            kw["cg_kwargs"] = {"maxiter": self.max_iter}
        return self._inner(image01, trimap, **kw)

    def __enter__(self):
        REFINE.estimate_alpha_cf = self
        return self

    def __exit__(self, *exc):
        REFINE.estimate_alpha_cf = self._inner


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _check_alpha(a, hw, what):
    if a.dtype != np.uint8 or a.shape != tuple(hw):
        fail(f"{what}: alpha is {a.dtype} {a.shape}, expected uint8 {hw}")


def run_compat(label: str) -> None:
    h, w = COMPAT_HW
    rgb, soft_alpha, user = compat_case(h, w, seed=7)
    zero_counts()

    # AI background removal: the full U^2-Net at its published widths
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    REMBG.rembg_remove_bgr_to_rgba(bgr, model="u2net")  # warm-up (cuDNN plans)
    rgba, ms = _timed(lambda: REMBG.rembg_remove_bgr_to_rgba(bgr,
                                                             model="u2net"))
    if rgba.dtype != np.uint8 or rgba.shape != (h, w, 4):
        fail(f"rembg: output is {rgba.dtype} {rgba.shape}")
    if not np.array_equal(rgba[..., :3], rgb):
        fail("rembg: the colour channels are not the input's")
    if not np.isin(rgba[..., 3], (0, 255)).all():
        fail("rembg: sharp alpha is not in {0, 255}")
    sess = REMBG._get_session("u2net")
    n_par = sum(p.numel() for p in sess.module.parameters())
    print(f"[compat] rembg_remove_bgr_to_rgba(u2net, {n_par / 1e6:.1f} M "
          f"parameters, seeded) {h}x{w}: ok, opaque share "
          f"{(rgba[..., 3] > 0).mean():.3f}; {ms:.3f} ms ({label})")
    cnn_alpha = sess.predict_mask(rgb)

    # refine from the CNN's alpha: seeded weights give a meaningless mask,
    # so any rung of the ladder may answer, and each is capped (uncapped,
    # the float64 polish runs thousands of iterations on it)
    with RungRecorder(max_iter=SEEDED_REFINE_CAP) as rec:
        out, ms = _timed(lambda: REFINE.refine_alpha_portrait(
            rgb, cnn_alpha, user))
    _check_alpha(out, (h, w), "refine from the CNN alpha")
    info = dict(MAT.LAST_SOLVE_INFO)
    answered = rec.calls[-1] if info or rec.calls[-1] != "x64" \
        else "x64 or the morphological refine"
    print(f"[compat] refine_alpha_portrait from the CNN alpha {h}x{w}, rungs "
          f"capped at {SEEDED_REFINE_CAP} iterations: rungs "
          f"run {rec.calls}, answered by {answered} (f32 iterations "
          f"{info.get('f32_iters')}, polish iterations "
          f"{info.get('polish_iters')}, polish converged "
          f"{info.get('polish_converged')}); {ms:.3f} ms ({label})")

    # refine from a soft-edged alpha with strokes: rung 1 must answer
    with RungRecorder() as rec:
        out, ms = _timed(lambda: REFINE.refine_alpha_portrait(
            rgb, soft_alpha, user))
    info = dict(MAT.LAST_SOLVE_INFO)
    _check_alpha(out, (h, w), "refine from the synthetic alpha")
    if rec.calls != ["basic"]:
        fail(f"synthetic refine: rungs {rec.calls} ran, expected the first")
    if not (info.get("f32_iters", 0) > 0 and info.get("polish_converged")
            and info.get("polish_backend") == "f64"):
        fail(f"synthetic refine: no f32 solve + converged f64 polish: {info}")
    if not ((out[user == 1] == 255).all() and (out[user == 2] == 0).all()):
        fail("synthetic refine: the strokes are not 255 and 0 in the output")
    agree = float((np.abs(out.astype(np.int32) - soft_alpha) <= 32).mean())
    if agree < 0.95:
        fail(f"synthetic refine: only {agree} of the alpha is near its init")
    print(f"[compat] refine_alpha_portrait from the synthetic alpha {h}x{w} "
          f"(solved at 768x1024): rung 1, f32 {info['f32_iters']} iterations "
          f"{info['t_f32'] * 1e3:.3f} ms, float64 polish on the card "
          f"{info['polish_iters']} iterations {info['t_polish'] * 1e3:.3f} ms; "
          f"{ms:.3f} ms in all ({label})")

    out_full, ms = _timed(lambda: REFINE.refine_alpha_portrait_full_res(
        rgb, soft_alpha, user))
    _check_alpha(out_full, (h, w), "full-resolution refine")
    if not ((out_full[user == 1] == 255).all()
            and (out_full[user == 2] == 0).all()):
        fail("full-resolution refine: the strokes are not enforced")
    print(f"[compat] refine_alpha_portrait_full_res {h}x{w}: ok; {ms:.3f} ms "
          f"({label})")
    print(f"[compat] kernel launches on the compat path: "
          f"{ {k: v for k, v in read_counts().items() if v} }")

    # the plain full-inverse matvec the compat rungs run, for the record
    g = torch.Generator(device="cuda").manual_seed(8)
    for dt in (torch.float32, torch.float64):
        img = torch.rand((1, 3, 768, 1024), generator=g, device="cuda",
                         dtype=dt)
        p = torch.randn((1, 768, 1024), generator=g, device="cuda", dtype=dt)
        pre = MAT._precompute(img, 1e-7, 1)
        ms = median_ms(lambda: MAT._matvec(pre, p, 1))
        print(f"[compat] plain full-inverse matvec 1x768x1024 {dt}: "
              f"{ms:.4f} ms ({label})")

    # card against CPU
    sh, sw = COMPAT_SMALL_HW
    rgb_s, alpha_s, user_s = compat_case(sh, sw, seed=9)
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = REFINE.refine_alpha_portrait(rgb_s, alpha_s, user_s,
                                                device=dev)
        dt_ms = (time.perf_counter() - t0) * 1e3
        info = dict(MAT.LAST_SOLVE_INFO)
        if not info.get("polish_converged"):
            fail(f"refine {sh}x{sw} on {dev}: rung 1 did not answer: {info}")
        print(f"[compat] refine_alpha_portrait {sh}x{sw} on {dev}: f32 "
              f"{info['f32_iters']} iterations, polish {info['polish_iters']}; "
              f"{dt_ms:.3f} ms ({label})")
    d = np.abs(res["cuda"].astype(np.int32) - res["cpu"].astype(np.int32))
    print(f"[compat] card against CPU {sh}x{sw}: uint8 alpha equal on "
          f"{(d == 0).mean():.6f}, max step {d.max()}")
    if d.max() > 1 or (d == 0).mean() < 0.999:
        fail("compat refine differs between the card and the CPU")


# ---------------------------------------------------------------------------
# phase 8: the quantize and histogram micros, the paths that launch K7, K8
# ---------------------------------------------------------------------------

def run_micros(label: str) -> dict:
    zero_counts()
    res = BENCH_QUANT.run("cuda", BATCH, H4K, W4K)
    print(f"[micros] quantize {BATCH}x{H4K}x{W4K} k=16: K4 on the interleaved "
          f"frame {res['k4_ms']:.4f} ms; K7 on planes {res['k7_kernel_ms']:.4f}"
          f" ms, with the split ({res['split_ms']:.4f} ms) and the stack "
          f"({res['stack_ms']:.4f} ms) {res['k7_function_ms']:.4f} ms; "
          f"bit-equal: {res['equal']} ({label})")
    if not res["equal"]:
        fail("micro_quantize: K7's output differs from K4's")
    rows = BENCH_HIST.run("cuda", H4K * W4K, BATCH)
    torch.cuda.synchronize()
    by_input = {}
    for row in rows:
        by_input.setdefault(row["input"], []).append(row)
        if not row["exact"]:
            fail(f"micro_hist_nibble: {row['kernel']} on {row['input']} "
                 "differs from np.bincount")
    for name, group in by_input.items():
        times = ", ".join(f"{r['kernel']} {r['ms']:.4f}" for r in group)
        print(f"[micros] histogram of {name} ({H4K * W4K} a row), all exact, "
              f"ms: {times} ({label})")
    launches = {k: v for k, v in read_counts().items() if k in MICRO_PATH}
    print(f"[micros] kernel launches in the two bench runs: {launches}; per "
          f"variant {K8.VARIANT_LAUNCHES}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by its bench")
    if min(K8.VARIANT_LAUNCHES.values()) <= 0:
        fail("a variant of hist_variants was not launched by its bench")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the colour quantizers
# ---------------------------------------------------------------------------

def quantizer_frame(h: int, w: int, seed: int, mask: int = 0xFF) -> np.ndarray:
    """Photo-like RGBA with a transparent corner, a semi-transparent band
    and a dark patch; `mask` drops low colour bits (fewer unique colours)."""
    rgb = photo_batch(1, h, w, seed)[0] & np.uint8(mask)
    rgba = np.dstack([rgb, np.full((h, w), 255, np.uint8)])
    rgba[: h // 5, : w // 4, 3] = 0
    rgba[h // 3: h // 3 + h // 10, :, 3] = 100
    dark = rgba[2 * h // 3: 5 * h // 6, w // 2: 5 * w // 6, :3]
    dark //= 24
    return np.ascontiguousarray(rgba)


CUSTOM_PALETTE = np.array(
    [[230, 40, 40], [40, 200, 60], [40, 60, 220], [20, 20, 20],
     [235, 235, 235], [200, 170, 60], [120, 60, 160], [90, 140, 150]], np.uint8)


def quantizer_calls(k16_hw, classical_hw, perceptual_hw):
    """(name, frame size, colours, call(rgba, device)) per entry point."""
    def adaptive(name, k):
        return lambda rgba, dev: CS.simplify_colors_adaptive(
            rgba, k, True, name, device=dev)
    calls = [("kmeans", k16_hw, 16, adaptive("kmeans", 16))]
    calls += [(n, classical_hw, 8, adaptive(n, 8))
              for n in ("median_cut", "octree", "threshold")]
    calls += [(n, perceptual_hw, 8, adaptive(n, 8))
              for n in ("perceptual", "perceptual_fast", "adaptive_distance",
                        "hsv_clustering")]
    calls.append(("custom_palette(lab)", perceptual_hw, 8,
                  lambda rgba, dev: CS.simplify_colors_custom_palette(
                      rgba, CUSTOM_PALETTE, True, "lab", device=dev)))
    return calls


def check_quantized(name: str, rgba, out, pal, k: int) -> None:
    if out.dtype != np.uint8 or out.shape != rgba.shape:
        fail(f"{name}: output is {out.dtype} {out.shape}")
    if pal.ndim != 2 or pal.shape[1] != 3 or not 2 <= len(pal) <= k:
        fail(f"{name}: palette shape {pal.shape}")
    if name != "threshold" and len(pal) != k:
        fail(f"{name}: {len(pal)} palette entries, expected {k}")
    if not np.array_equal(out[..., 3], rgba[..., 3]):
        fail(f"{name}: alpha was not preserved")
    opaque = out[out[..., 3] > 0][:, :3].astype(np.int64)
    codes = np.unique((opaque[:, 0] << 16) | (opaque[:, 1] << 8) | opaque[:, 2])
    p = pal.astype(np.int64)
    allowed = set(((p[:, 0] << 16) | (p[:, 1] << 8) | p[:, 2]).tolist())
    if name == "kmeans":
        allowed.add(0)  # pixels the black filter left out of the fit
    if not set(codes.tolist()) <= allowed:
        fail(f"{name}: an opaque colour of the output is not in its palette")


def _stamps(name: str) -> dict:
    if name == "hsv_clustering":
        return dict(CS.LAST_SOLVE_INFO)
    if name == "adaptive_distance":
        return dict(PERCEPTUAL.LAST_SOLVE_INFO)
    return {}


def run_quantizers(label: str) -> None:
    frames = {}

    def frame(hw, mask=0xFF):
        if (hw, mask) not in frames:
            frames[hw, mask] = quantizer_frame(*hw, seed=11, mask=mask)
        return frames[hw, mask]

    calls = quantizer_calls((1024, 1024), (1080, 1920), (H4K, W4K))
    for name, hw, k, call in calls:
        rgba = frame(hw)
        out, pal = call(rgba, "cuda")  # also the warm-up
        check_quantized(name, rgba, out, pal, k)
        (out2, pal2), ms = _timed(lambda: call(rgba, "cuda"))
        if not (np.array_equal(out, out2) and np.array_equal(pal, pal2)):
            fail(f"{name}: a second call gives other bytes")
        info = _stamps(name)
        times = {key: v for key, v in info.items() if key.startswith("t_")}
        counts = {key: v for key, v in info.items() if key.startswith("n_")}
        stages = ""
        if times:
            listed = ", ".join(f"{key} {v * 1e3:.3f}" for key, v in times.items())
            share = sum(times.values()) * 1e3 / ms
            stages = (f"; stamps {listed} ms, {share * 100:.1f} % of the call; "
                      f"{counts}")
            if not 0.9 <= share <= 1.1:
                fail(f"{name}: the stage stamps sum to {share:.3f} of the "
                     "call's wall, outside 10 %")
        print(f"[quantizers] {name} {hw[0]}x{hw[1]} k={k}: ok, second call "
              f"identical; warm {ms:.3f} ms{stages} ({label})")

    # card against CPU: bytes are not promised (CUDA's logf and pow are not
    # the CPU's), agreement is
    sh, sw = QUANT_SMALL_HW
    small = frame(QUANT_SMALL_HW, mask=0xF8)
    for name, _, k, call in quantizer_calls(*[QUANT_SMALL_HW] * 3):
        t0 = time.perf_counter()
        g_out, g_pal = call(small, "cuda")
        t1 = time.perf_counter()
        c_out, c_pal = call(small, "cpu")
        t2 = time.perf_counter()
        agree = float((g_out == c_out).all(axis=-1).mean())
        print(f"[quantizers] {name} {sh}x{sw} card against CPU: pixel "
              f"agreement {agree:.6f}, palettes identical "
              f"{bool(np.array_equal(g_pal, c_pal))}; card "
              f"{(t1 - t0) * 1e3:.1f} ms, CPU {(t2 - t1) * 1e3:.1f} ms "
              f"({label})")
        if agree < 0.99:
            fail(f"{name}: card-vs-CPU agreement {agree} < 0.99")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    label = card_label()
    print(f"[card] {label}")
    strict_f32()
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
          f"{time.perf_counter() - t0:.1f} s")

    results = {
        "histogram": check_histogram(label, dev),
        "precompute": check_precompute(label, dev),
        "matvec": check_matvec(label, dev),
        "quantize": check_quantize(label, dev),
        "matvec_stack": check_matvec_stack(label, dev),
        "matvec_recompute": check_matvec_recompute(label, dev),
        "quantize_flat": check_quantize_flat(label, dev),
        "hist_variants": check_hist_variants(label, dev),
    }
    launches = run_slice(label)
    card_vs_cpu(label)
    launches.update(run_variants(label))
    run_compat(label)
    launches.update(run_micros(label))
    run_quantizers(label)

    print(f"[total] every phase passed in {time.perf_counter() - t_start:.1f} s")
    table = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[name], **results[name]}
             for name, (_, _, src, rep) in KERNELS.items()]
    print(label)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
