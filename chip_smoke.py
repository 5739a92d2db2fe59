"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each raising (and exiting non-zero) on failure:
1. card: CUDA must be present; prints the card name and power limit;
2. build: compiles the CUDA kernels from kernels/csrc with nvcc (K1-K8,
   the matting CG's update, SAM's encoder attention, the resize and
   BiRefNet's deformable convolution and window attention);
3. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes and at ragged shapes, with warm timings, its bound
   (the least time the card could take: bytes over the memory rate or
   operations over the float32 rate, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time; K5 and K6
   also against K3's output on the same operands, K7 against K4's, every
   variant of K8 against K1's. K3 must give the plain version's bits at
   every shape, and K6 too (also on a `valid` plane with holes); K4 and K7
   are checked and timed on whole-number palettes (their integer path, the
   main path's case), on fractional ones and on a batch that mixes the two.
   K2 must give the plain version's bits too
   (also at a width that is no multiple of 4 and on an image narrower than
   a strip); K1 is exact on random, all-equal and alpha-like rows, over 200
   calls made back to back on changing inputs, and a profile shows that a
   call is one device operation. Every variant of K8 likewise: exact on
   random, run, all-equal, alpha-like, ragged, unaligned and one-row
   inputs, over 200 calls back to back on changing inputs and variants and
   on two streams, one device operation a call. For every kernel the time
   of launches made back to back stands beside the time of one launch
   between two events, which also holds the host's way to the launch; for
   K1, K2 and every variant of K8 (on random, run and alpha-like rows, K1
   beside it) also the time of the same calls replayed from a CUDA graph,
   the device's alone. The CG's update (kernels/cg_update.py, three
   kernels an iteration, no TPU kernel: XLA fuses it) through
   CGLoop._step_fused against CGLoop._body on the card, bit for bit after
   every chunk, at 4 x 576 x 1024 and at a ragged shape, with images that
   restart, break down, converge and stop on a non-finite residual inside
   a chunk; then bench/micro_cg_iter.run at 4 x 576 x 1024: an iteration
   from a CUDA graph, plain against fused, and each kernel's device time
   beside its bound (5, 7 and 4.875 planes). SAM's encoder attention
   (kernels/sam_attention.py, no TPU kernel: the JAX package has no SAM)
   at ViT-H's global (4 x 16 x 4096, d 80) and windowed (100 x 16 x 196)
   shapes against its plain version, timed one launch, back to back and
   from a CUDA graph beside its bound (the products at the bf16 rate, or
   q, k, v, the output and the tables once at the memory's) and beside
   the library path it replaced (the bias as a bf16 mask and
   F.scaled_dot_product_attention), each output within 2^-7 of its row's
   probability-weighted |v| and of its own size. The resize
   (kernels/resample.py, no TPU kernel: XLA's dot does the JAX package's)
   at the 4K main path's eight resizes (U2-Netp's five, ISNet's two
   Lanczos, SAM's BILINEAR_PIL) against the dense float64 contraction,
   byte for byte, timed one launch, back to back and from a CUDA graph
   beside its bound (the nonzero taps' float64 multiply-adds at the
   float64 rate, or the u8 in and out at the memory's) and beside the
   dense path's time. BiRefNet's deformable convolution
   (kernels/deform_conv.py, no TPU kernel: the JAX package has no
   BiRefNet) at its twelve published shapes (k 1, 3, 7 at 32 to 256
   square, batch 4) against its plain version, also into a channel slice
   of the branches' concatenation, timed one launch, back to back and
   from a CUDA graph beside its bound (the products at the bf16 rate, or
   its operands and output once at the memory's). BiRefNet's window
   attention (kernels/swin_attention.py, no TPU kernel) at every grid of
   Swin-L's stages in a call (256 to 16 a side, batch 4, shift 0 and 6)
   against its plain version (the materialised windows and mask and
   SDPA, the path it replaced), timed likewise beside its bound, and a
   call's 48 launches summed;
4. slice: Pipeline(model="u2netp", k=16).run on a seeded 4 x 2160 x 3840
   photo-like batch, compiled (captured as CUDA graphs at its first call,
   replayed after): output checks, MAIN_PATH_SHA256, the eager stages'
   bytes and CG and Lloyd counts, per-kernel launch counts from the
   replays (K3 in whole CG chunks, the CG's update three a K3 launch but
   the first), the same sha256 from a call traced
   under torch.profiler and its spans' CG chunks, a call on other images
   that leaves the first call's outputs alone, a bit-identical third run, the
   compiled wall beside the eager stages', the device busy time and idle
   share, the peak memory, and a second shape (2 x 1080 x 1920) with a
   program of its own; then Pipeline(model="sam_vit_h", k=16).run on the
   same batch with one box a frame (the SAM cell's shape), compiled: the
   launches of a replayed call (SAM's attention one a block, 32; K1-K4
   and the CG's update from the stages after the network), output
   checks, the eager run's bytes, a bit-identical second replay, the wall;
   then Pipeline(model="birefnet-general", k=16).run on the same batch:
   20 deformable and 48 window-attention launches and 4 frames a
   replayed call, the same checks,
   and that replayed call's network logits against
   benchmark/reference/birefnet_plain.py in float32 (`logit_rel`, with
   the float8 control beside it, which must fail the limit);
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
   K7 at 4 x 2160 x 3840, bit-equal, and K4 and K7 back to back on a
   whole-number palette, a fractional one, the two mixed and no palette
   entry at all) and bench/micro_hist_nibble.run (every
   variant of K8 and K1 on random, run and alpha-like rows, exact against
   np.bincount, back to back and from a CUDA graph), the paths that launch
   K7 and K8;
9. the colour quantizers of compat/color_simplify on photo-like RGBA with
   a transparent and a dark region: kmeans at 1024 x 1024, the classical
   batch at 1080 x 1920, the perceptual family at 2160 x 3840; output
   checks, a second call with the same bytes, warm times with the stage
   stamps, and card against CPU on a 270 x 480 frame;
10. GrabCut at BASELINE config 4's shape: apply_grabcut with the rect
   (w/8, h/12, 3w/4, 9h/10), 10 iterations and the split-merge polish on
   three seeded 1024 x 768 portrait scenes, compiled (the units captured
   as CUDA graphs at the first call): uint8 in {0..3}, known pixels
   passed through, the first call (warm-up and captures, the programs and
   graphs, the peak and reserved memory) and a bit-identical warm call,
   the private eager path's bytes, cut iterations and restart flag on
   every scene, both walls beside the LAST_SOLVE_INFO stamps (which must
   sum to within 10 % of the compiled wall); one compiled and one eager
   call under the profiler (device busy, idle share, operations, host
   reads); the Chambolle-Pock loop's ms an iteration from a graph and
   eagerly; run_grabcut_workflow once with strokes; mask_energy's lanes
   against one-lane calls; card against CPU on a 120 x 160 scene
   (foreground IoU >= 0.99);
11. ISNet: rembg_remove_bgr_to_rgba(model="isnet-general-use") on phase
   7's 1536 x 2048 frame at the published 1024 x 1024 input (alpha in
   {0, 255}, K1 launched), card against CPU on 384 x 512 (sharp alpha
   agreement >= 0.99), and the seeded ISNet written to .onnx by the
   port's writer, loaded by a Session (complete, the seeded session's
   mask bytes) and by tools/verify_checkpoint.verify.
12. region cleanup at 4K on image 0 of phase 4's output (the k-16
   palette, alpha in {0, 255}): analyze_regions and merge_small_regions
   (min size 100, connectivity 8; the passes, and the regions under 100
   before and after), get_region_boundaries, flood_fill_region at a fixed seed,
   trim_tendrils (threshold 2, 30 iterations) on the merged frame, and on
   a 1080 x 1920 crop of it the five smoothers at strength 0.5,
   apply_boundary_smoothing_global (cap 100, tendrils on; its 30 s clock
   must not be what ends it) and apply_custom_morphological_smoothing;
   each step twice (same bytes), opaque colours from its input's palette,
   warm walls; compare_smoothing_algorithms entry by entry against the
   direct calls; the device's component_stats beside the native
   union-find on the same frame (equal labels, sizes and bboxes) with the
   host reads of its fixpoint; and card against CPU on a 270 x 480 crop
   (equal bytes; gaussian and bilateral within one step, 99 % equal).
13. the CLI (`cli.main` in this process) on seeded PNGs written by its own
   codec: run A, 768 x 1024, u2netp rembg + kmeans 8 + cleanup +
   morphological + trim 2 + stats; run B, a 384 x 512 portrait, GrabCut
   at config 4's rect + portrait refine + a three-colour palette +
   majority; run C, 768 x 1024, rembg with the default ISNet and no
   simplification. Each twice (same bytes), with its wall, the output's
   shape, alpha in {0, 255} after the sharp rembg, the opaque colours, the
   stats JSON and K1's launches (A and C); export_svg of A's output; run A
   again as `python -m image_segmenter_tpu_torch.cli` (the same bytes and
   stats); run B's flags without the refine at 96 x 128 on the card and
   the CPU (>= 0.99 of the pixels equal).
14. training: pipeline/train on U^2-Netp at 320 x 320, batch 8, float32:
   ms per step (median of 20 after 2 warm-up) and images per second, peak
   memory, the loss falling from step 0 to step 20, the device's busy
   share and largest operations from utils/profiling.capture_device_trace
   over 3 steps, a checkpoint at step 10 restored bit for bit whose next
   step's loss is the uninterrupted run's (1e-4), no port kernel launched,
   and one step at 2 x 64 x 64 on the card against the CPU (loss 1e-4
   relative, gradients relative L2 0.1 median and 0.25 each, statistics
   1e-3). Phase 4 also holds Pipeline.run's outputs to their sha256.
15. the device mesh, every slot on this card: Pipeline(sharding=
   batch_sharding(make_mesh((2, 2)))) on phase 4's batch (outputs, the
   dry run's boundary-band contract against phase 4's output, a
   bit-identical second run, K1-K4 launches, the wall; and from phase 4's
   CNN mask the sharded matting and quantize stages against the
   unsharded bytes); refine_alpha_portrait_full_res split over (1, 4) on
   phase 7's frame against the unsplit bytes; K2 and K3 on the solve's
   row blocks (first, interior, last, and own blocks of 5, 8, 12 and 291
   rows with their ghost rows) against their plain versions' bits and
   against the whole image's rows; StagedPipeline (2, 1, 1) streaming
   three distinct 4 x 2160 x 3840 batches, in order, under the dry run's
   contract against the fused runs; graft_entry.dryrun_multichip(4); and
   the training step over two gloo ranks at U^2-Netp's 320 x 320, batch
   8, 3 steps, with whole rows (a slot a rank) and with each rank's rows
   split over two slots, against one rank.
16. the training step's rows split over the space axis:
   shard_train_step on U^2-Netp at 320 x 320, batch 8, over (1, 2),
   (1, 4) and (2, 2) slots of this card, 3 steps each, every step held
   to the one-slot step from the same state (loss 1e-4 relative; after
   step 1 the fuse conv 1e-4 and the statistics 1e-3; every parameter
   moved), with ms a step, device operations and busy share of one
   profiled step and the peak memory; the full U^2-Net, batch 2, one
   step over (1, 2); on a host with two (four) cards (1, 2) ((1, 4)) a
   card a slot beside the one card's peak (else "not measured"); no port
   kernel launched.
17. the measuring programs of bench/: `python -m
   image_segmenter_tpu_torch.bench.bench` as a subprocess at 4 x 2160 x
   3840 (BENCH_REPS 2, no secondary model): exactly one stdout line that
   parses, the photo mosaic's (`..._b4_photo`, content "photo"), and the
   synthetic batch's record on stderr, each with every field, value > 0,
   the card's label and phase 4's K1, K2 and K4 launches;
   profile_stages.profile once on phase 4's batch (every stage row with
   its device view, its K1-K4 launches in one run equal to phase 4's, an
   idle share in [0, 1]); BASELINE configs 1, 2, 4 (GrabCut compiled)
   and 5 with one rep each.
18. the photo corpus (bench/corpus): its 14 PNGs decoded here against
   the sha256s of MANIFEST.json; bench/corpus_iou.run_image on china,
   flower, sky_01-up and a floor at 256 x 256 (mask IoU >= 0.99 against
   the float64 oracle; the card's alpha within one step of the CPU's on
   >= 0.999 of the pixels, equal alpha giving equal palettes);
   Pipeline.run on a 1 x 1080 x 1920 tile of the bench's photo mosaic
   against the CPU (phase 5's rule: alpha agreement >= 0.99, the same
   bytes after the CNN; K1-K4 and the CG's update launched); each
   attribution micro (chip_envelope, micro_u2netp_pack, micro_kmeans_restart,
   micro_fit_sample, micro_hsv_fit, micro_dbscan) once at its default
   shape (one warm and one timed call), one JSON line each with the card's
   label.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
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
from image_segmenter_tpu_torch import graft_entry as GRAFT
from image_segmenter_tpu_torch.bench import baseline_configs as BASELINE
from image_segmenter_tpu_torch.bench import bench as BENCH_HEAD
from image_segmenter_tpu_torch.bench import chip_envelope as MICRO_ENVELOPE
from image_segmenter_tpu_torch.bench import corpus as CORPUS
from image_segmenter_tpu_torch.bench import corpus_iou as CORPUS_IOU
from image_segmenter_tpu_torch.bench import micro_dbscan as MICRO_DBSCAN
from image_segmenter_tpu_torch.bench import micro_fit_sample as MICRO_FIT_SAMPLE
from image_segmenter_tpu_torch.bench import micro_hsv_fit as MICRO_HSV_FIT
from image_segmenter_tpu_torch.bench import micro_kmeans_restart as MICRO_KMEANS
from image_segmenter_tpu_torch.bench import micro_u2netp_pack as MICRO_U2NETP
from image_segmenter_tpu_torch.bench import micro_cg_iter as MICRO_CG
from image_segmenter_tpu_torch.bench import micro_hist_nibble as BENCH_HIST
from image_segmenter_tpu_torch.bench import micro_matvec as BENCH
from image_segmenter_tpu_torch.bench import micro_precompute_hist as BENCH_K12
from image_segmenter_tpu_torch.bench import micro_quantize as BENCH_QUANT
from image_segmenter_tpu_torch.bench import profile_grabcut as PROFILE_GC
from image_segmenter_tpu_torch.bench import profile_stages as PROFILE
from image_segmenter_tpu_torch.compat import _perceptual as PERCEPTUAL
from image_segmenter_tpu_torch.compat import color_simplify as CS
from image_segmenter_tpu_torch.compat import grabcut as GRABCUT
from image_segmenter_tpu_torch.compat import harness as HARNESS
from image_segmenter_tpu_torch.compat import matting_refine as REFINE
from image_segmenter_tpu_torch.compat import region_cleanup as REGION_CLEANUP
from image_segmenter_tpu_torch.compat import rembg_infer as REMBG
from image_segmenter_tpu_torch.compat import tendril_trimming as TENDRILS
from image_segmenter_tpu_torch.config import DEFAULTS
from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels import cg_update as KCG
from image_segmenter_tpu_torch.kernels import deform_conv as KDC
from image_segmenter_tpu_torch.kernels import hist_variants as K8
from image_segmenter_tpu_torch.kernels import histogram as KH
from image_segmenter_tpu_torch.kernels import matting as K6
from image_segmenter_tpu_torch.kernels import matvec as KMV
from image_segmenter_tpu_torch.kernels import precompute as KP
from image_segmenter_tpu_torch.kernels import quantize as KQ
from image_segmenter_tpu_torch.kernels import quantize_flat as K7
from image_segmenter_tpu_torch.kernels import resample as KRS
from image_segmenter_tpu_torch.kernels import sam_attention as KSA
from image_segmenter_tpu_torch.kernels import swin_attention as KSW
from image_segmenter_tpu_torch.models import onnx_writer as ONNX_WRITER
from image_segmenter_tpu_torch.models import registry as REG
from image_segmenter_tpu_torch.models.u2net import U2NET
from image_segmenter_tpu_torch.ops import connected_components as CCOMP
from image_segmenter_tpu_torch.ops import native as NATIVE
from image_segmenter_tpu_torch.ops import resize as RZ
from image_segmenter_tpu_torch.ops.color import pack_rgb_u32 as PACK
from image_segmenter_tpu_torch.parallel import mesh as PM
from image_segmenter_tpu_torch.pipeline import segment as SEG
from image_segmenter_tpu_torch.pipeline import train as TRAIN
from image_segmenter_tpu_torch.pipeline.compiled import Compiled
from image_segmenter_tpu_torch.pipeline.segment import Pipeline
from image_segmenter_tpu_torch.pipeline.staged import StagedPipeline, \
    split_stage_meshes
from image_segmenter_tpu_torch.solvers import grabcut as GC
from image_segmenter_tpu_torch.solvers import matting as MAT
from image_segmenter_tpu_torch.tools import verify_checkpoint as VERIFY
from image_segmenter_tpu_torch.utils import profiling as PROF
from image_segmenter_tpu_torch.utils import seeds as SEEDS
from image_segmenter_tpu_torch.utils import svg_export as SVG
from image_segmenter_tpu_torch.utils.backend import strict_f32
from image_segmenter_tpu_torch.utils.loops import drive

BATCH, H4K, W4K = 4, 2160, 3840
MH, MW = 576, 1024          # matting size of a 2160 x 3840 frame
RAGGED = (37, 53)
MATVEC_SHAPES = [(BATCH, MH, MW), (2, *RAGGED), (1, 33, 130)]
# K3 only: several strips and several runs with a ragged edge
MATVEC_STRIP_SHAPES = [(2, 203, 389)]
CARD_VS_CPU = (1, 720, 1280)  # over matting_dim: the AREA shrink path runs
COMPAT_HW = (1536, 2048)      # the compat path's frame (shrunk to 768 x 1024)
COMPAT_SMALL_HW = (384, 512)  # card against CPU
SEEDED_REFINE_CAP = 400       # CG iterations a rung may take on the seeded mask
QUANT_SMALL_HW = (270, 480)   # the quantizers, card against CPU
GRABCUT_HW = (1024, 768)      # BASELINE config 4's portrait crops
GRABCUT_SMALL_HW = (120, 160)  # GrabCut, card against CPU
ISNET = "isnet-general-use"
REPS = 10
BACK_TO_BACK = 20             # launches between two events, host gap hidden
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
    "cg_update": (KCG, "LAUNCHES", _CSRC + "cg_update.cu",
                  "none (XLA fuses the CG's update around "
                  + _TPU + "pallas_matvec.py:271)"),
    "sam_attention": (KSA, "LAUNCHES", _CSRC + "sam_attention.cu",
                      "none (the JAX package has no SAM)"),
    "resample": (KRS, "LAUNCHES", _CSRC + "resample.cu",
                 "none (XLA's dot runs the JAX package's resizes)"),
    "deform_conv": (KDC, "LAUNCHES", _CSRC + "deform_conv.cu",
                    "none (the JAX package has no BiRefNet)"),
    "swin_attention": (KSW, "LAUNCHES", _CSRC + "swin_attention.cu",
                       "none (the JAX package has no BiRefNet)"),
}
MAIN_PATH = ("histogram", "precompute", "matvec", "quantize")
# the main path on one card: also the CG's update, which a solve split
# over slots (phase 15) leaves to CGLoop._body, and the resizes
SLICE_PATH = MAIN_PATH + ("cg_update", "resample")
# sha256 (first 16 hex digits) of Pipeline.run's outputs on phase 4's batch,
# unchanged since the kernels' redesigns kept every bit
# (bench/micro_precompute_hist.py cuda pipeline prints the same)
MAIN_PATH_SHA256 = {"rgba": "9cf4123f94c4acdf", "alpha": "e349a936c097a596",
                    "palettes": "eae64cfc02e36e26"}
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
    return BENCH_HEAD.card_label(torch.device("cuda", 0))


def median_ms(fn, reps: int = REPS, inner: int = 1) -> float:
    """Median of `reps` warm runs, each timed with CUDA events. A run is
    `inner` calls and its time is divided by `inner`: with one call the
    time holds the host's way from the first event to the launch (some
    15-20 us through a Python wrapper), with many back to back it does
    not."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


# smooth gradients + sensor-like noise (bench.py's synthetic recipe),
# phase-shifted per image so the images differ
photo_batch = BENCH_K12.photo_batch


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _bincount(x: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call that computes K1's function: bincount on
    values offset by 256 per row (the conversion it needs is timed too)."""
    offs = (torch.arange(x.shape[0], device=x.device) * 256)[:, None]
    return torch.bincount((x.to(torch.int64) + offs).flatten(),
                          minlength=256 * x.shape[0]).reshape(-1, 256)


def _device_operations(fn, calls: int = 10, attempts: int = 3):
    """Names of the device operations (kernels, memsets, copies) that
    `calls` calls of `fn` put on the card, from torch.profiler.

    The profiler can drop a record (one run counted 9 operations in 10
    calls of a one-kernel function), never add one, so a count under
    `calls` is taken again, up to `attempts` times; a count over `calls`
    is returned at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if len(ops) >= calls:
            break
    return ops


def check_histogram(label: str, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randint(0, 256, (BATCH, H4K * W4K), generator=g,
                      dtype=torch.uint8, device=dev)
    x[0, :1 << 20] = 255  # a long run of one value
    # what the main path counts: planes that are mostly 0 and 255
    alpha = torch.from_numpy(BENCH_K12.alpha_like(
        BATCH, H4K * W4K, np.random.default_rng(1))).to(dev)
    hot = float(((alpha == 0) | (alpha == 255)).double().mean())
    if hot < 0.9:
        fail(f"histogram: the alpha-like plane has only {hot} of 0 and 255")
    cases = {"main": x, "ragged": x[:2, :RAGGED[0] * RAGGED[1]].contiguous(),
             "unaligned": x[1, 1:].reshape(1, -1), "alpha-like": alpha,
             "all-equal": torch.full((2, MH * MW), 255, dtype=torch.uint8,
                                     device=dev),
             "small": x[:, :MH * MW].contiguous(),
             "empty": x[:, :0].contiguous()}
    err = 0.0
    for name, xi in cases.items():
        got = KH.hist256(xi)
        ref = KH.hist256_plain(xi)
        if not torch.equal(got, ref):
            fail(f"histogram {name} {tuple(xi.shape)} differs from plain")
        if not torch.equal(got, _bincount(xi).to(ref.dtype)):
            fail(f"histogram {name} {tuple(xi.shape)} differs from bincount")
        err = max(err, float((got - ref).abs().max()))

    # 200 calls back to back on changing inputs: the kernel itself clears
    # its scratch, and no call may see another's counts
    pool = [c for c in cases.values() if c.numel()]
    refs = [_bincount(c).to(torch.float32) for c in pool]
    torch.cuda.synchronize()
    outs = [KH.hist256(pool[i % len(pool)]) for i in range(200)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        if not torch.equal(out, refs[i % len(pool)]):
            fail(f"histogram: call {i} of 200 back to back differs from "
                 "bincount")

    # one device operation a call: no memset, no cast
    ops = _device_operations(lambda: KH.hist256(x), calls=10)
    if ops:
        print(f"[kernels] histogram: 10 calls of hist256 put {len(ops)} "
              f"device operations on the card (torch.profiler): "
              f"{sorted(set(ops))}")
        if len(ops) != 10:
            fail(f"histogram: {len(ops)} device operations in 10 calls")
    else:
        print("[kernels] histogram: torch.profiler recorded no device "
              "operation; operations a call not measured")

    def times(xi):
        fn = lambda: KH.hist256(xi)  # noqa: E731
        return (median_ms(fn), median_ms(fn, inner=BACK_TO_BACK),
                BENCH_K12.graph_ms(fn, BACK_TO_BACK, REPS))

    ms, b2b, graph = times(x)
    a_ms, a_b2b, a_graph = times(alpha)
    s_ms, s_b2b, s_graph = times(cases["small"])
    plain_ms = median_ms(lambda: KH.hist256_plain(x))
    library_ms = median_ms(lambda: _bincount(x))
    # x read once, (B, 256) float32 written; one increment per element
    bd = bound(x.numel() + x.shape[0] * 256 * 4, x.numel())
    print(f"[kernels] histogram {tuple(x.shape)} u8: exact on 7 inputs and "
          f"over 200 calls back to back; random bytes {ms:.4f} ms one launch "
          f"between events, {b2b:.4f} back to back, {graph:.4f} from a CUDA "
          f"graph; alpha-like plane ({hot:.3f} of 0 and 255) {a_ms:.4f}, "
          f"{a_b2b:.4f}, {a_graph:.4f}; (4, {MH * MW}) random {s_ms:.4f}, "
          f"{s_b2b:.4f}, {s_graph:.4f}; plain {plain_ms:.4f} ms, bincount "
          f"{library_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({label})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": library_ms, "ms_back_to_back": b2b,
            "ms_graph": graph, "ms_alpha_like": a_ms,
            "ms_alpha_like_back_to_back": a_b2b, "ms_alpha_like_graph": a_graph,
            "ms_small": s_ms, "ms_small_back_to_back": s_b2b,
            "ms_small_graph": s_graph}


def _precompute_err(got, ref) -> float:
    """Largest per-entry min(|diff|, |diff| / |ref|)."""
    err = (got - ref).abs()
    rel = err / ref.abs().clamp_min(1e-30)
    return float(torch.minimum(err, rel).max())


# K2 beyond the main path's shape: ragged, a width that is no multiple of 4
# over several strips, an image narrower than a strip, a single row
PRECOMPUTE_SHAPES = [(2, 3, *RAGGED), (1, 3, 203, 389), (2, 3, 19, 7),
                     (1, 3, 1, 64)]


def check_precompute(label: str, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(2)
    err_main = None
    for shape in [(BATCH, 3, MH, MW)] + PRECOMPUTE_SHAPES:
        img = torch.rand(shape, generator=g, device=dev)
        flat = torch.tensor([0.3, 0.6, 0.45], device=dev)[None, :, None, None] \
            + 1e-4 * (torch.rand(shape, generator=g, device=dev) - 0.5)
        for name, im in (("random", img), ("near-singular", flat)):
            got = KP.precompute_planes(im, 1e-7)
            ref = KP.precompute_planes_plain(im, 1e-7)
            e = _precompute_err(got, ref)
            if not e < 1e-4:
                fail(f"precompute {shape} {name}: min(abs, rel) error {e} "
                     ">= 1e-4")
            # the kernel keeps the plain version's order of sums, divides
            # by n to the same rounding, and is built without FMA
            # contraction: the same bits
            if not torch.equal(got, ref):
                fail(f"precompute {shape} {name}: not the plain version's "
                     "bits")
        if err_main is None:
            err_main = float((got - ref).abs().max())
            main_img = img
    fn = lambda: KP.precompute_planes(main_img, 1e-7)  # noqa: E731
    ms = median_ms(fn)
    b2b = median_ms(fn, inner=BACK_TO_BACK)
    graph = BENCH_K12.graph_ms(fn, BACK_TO_BACK, REPS)
    plain_ms = median_ms(lambda: KP.precompute_planes_plain(main_img, 1e-7))
    # 3 image planes read, 12 planes written. Operations per pixel: the
    # count and mean boxes and their division (19), pass A (9 shifts x 16),
    # pass B (9 x 16), pass C (9 x 15), the diag member sum (9 x 23), the
    # pivots, inverse entries and flag (about 45): about 690.
    px = BATCH * MH * MW
    bd = bound(15 * px * 4, 690 * px)
    print(f"[kernels] precompute (4, 3, {MH}, {MW}) f32: the plain version's "
          f"bits at every shape, random and near-singular; kernel {ms:.4f} ms "
          f"one launch between events, {b2b:.4f} back to back, {graph:.4f} "
          f"from a CUDA graph (strip {KP.STRIP}, runs of "
          f"{KP.run_rows(MH, MW, BATCH, _sms(dev))} rows), plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None, "ms_back_to_back": b2b, "ms_graph": graph}


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
    for b, h, w in MATVEC_SHAPES + MATVEC_STRIP_SHAPES:
        img, planes, p = _matvec_operands(g, dev, b, h, w)
        got = KMV.matvec_planes(planes, img, p)
        ref = KMV.matvec_planes_plain(planes, img, p)
        e = _rel_err(got, ref)
        if not e < 1e-5:
            fail(f"matvec {(b, h, w)}: max|diff|/max|ref| {e} >= 1e-5")
        # the kernel keeps the plain version's order of sums and the
        # library is built without FMA contraction: the same bits
        if not torch.equal(got, ref):
            fail(f"matvec {(b, h, w)}: not the plain version's bits")
        if err_main is None:
            err_main = float((got - ref).abs().max())
            args = (planes, img, p)
    ms = median_ms(lambda: KMV.matvec_planes(*args))
    b2b = median_ms(lambda: KMV.matvec_planes(*args), inner=BACK_TO_BACK)
    plain_ms = median_ms(lambda: KMV.matvec_planes_plain(*args))
    # 10 of K2's planes, 3 image planes and p read, one plane written
    px = BATCH * MH * MW
    bd = bound(15 * px * 4, MATVEC_OPS * px)
    # what the card's memory gives a PyTorch kernel that moves as many
    # bytes: an elementwise add, 5 + 5 planes in and 5 out
    x, y = torch.rand((2, 5 * px), generator=g, device=dev).unbind(0)
    z = torch.empty_like(x)
    stream_ms = median_ms(lambda: torch.add(x, y, out=z), inner=BACK_TO_BACK)
    print(f"[kernels] matvec (4, {MH}, {MW}) f32: the plain version's bits at "
          f"every shape, max|diff| {err_main:.3g}; kernel {ms:.4f} ms "
          f"one launch between events, {b2b:.4f} ms back to back (strip "
          f"{KMV.STRIP}, runs of {KMV.run_rows(MH, MW, BATCH, _sms(dev))} "
          f"rows), plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']}; torch.add moving the same bytes {stream_ms:.4f} "
          f"ms back to back ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None, "ms_back_to_back": b2b,
            "stream_ms": stream_ms}


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
    b2b = median_ms(lambda: KMV.matvec_stack(*args), inner=BACK_TO_BACK)
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
          f"kernel {ms:.4f} ms one launch between events, {b2b:.4f} back to "
          f"back, plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None, "ms_back_to_back": b2b}


def valid_with_holes(g, b: int, h: int, w: int, dev) -> torch.Tensor:
    """A `valid` plane of 1 with scattered holes, a hole of a few rows and
    columns, and a ragged right border."""
    valid = (torch.rand((b, h, w), generator=g, device=dev) > 0.1).float()
    valid[:, h // 3:h // 3 + 3, w // 4:w // 4 + 5] = 0.0
    cut = torch.randint(0, min(w, 4) + 1, (h,), generator=g, device=dev)
    valid[:, torch.arange(w, device=dev)[None, :] >= (w - cut)[:, None]] = 0.0
    return valid


def check_matvec_recompute(label: str, dev) -> dict:
    """K6 against its plain version bit for bit (its whole output), on a
    `valid` plane of ones and on one with holes and a ragged border, and
    against K3's matvec inside the image (ones)."""
    g = torch.Generator(device=dev).manual_seed(6)
    err_main = None
    for b, h, w in MATVEC_SHAPES + MATVEC_STRIP_SHAPES:
        img, planes, p = _matvec_operands(g, dev, b, h, w)
        p_pad = K6.pad_p(p)
        for masked in (False, True):
            valid = valid_with_holes(g, b, h, w, dev) if masked \
                else torch.ones_like(p)
            static = K6.pack_static(valid, img, planes[:, 0:6])
            got = K6.matvec_planes(p_pad, static)
            ref = K6.matvec_planes_plain(p_pad, static)
            # the kernel keeps the plain version's order of every sum and
            # the library is built without FMA contraction: the same bits
            if not torch.equal(got, ref):
                fail(f"matvec_recompute {(b, h, w)} masked={masked}: not the "
                     f"plain version's bits (max|diff| "
                     f"{float((got - ref).abs().max())})")
            if masked:
                continue
            k3 = KMV.matvec_planes(planes, img, p)
            scale = k3.abs().max()
            e3 = _rel_err(got[:, :h, :w], k3, scale)
            if not e3 < 1e-5:
                fail(f"matvec_recompute {(b, h, w)}: max|diff|/max|ref| {e3} "
                     "against K3 (bound 1e-5)")
            if err_main is None:
                err_main = float((got - ref).abs().max())
                err_k3 = e3
                args = (p_pad, static)
    ms = median_ms(lambda: K6.matvec_planes(*args))
    b2b = median_ms(lambda: K6.matvec_planes(*args), inner=BACK_TO_BACK)
    plain_ms = median_ms(lambda: K6.matvec_planes_plain(*args))
    # the least the function must move: 10 static planes and p at the
    # image and its halo of 2 read (the zero columns beyond W + 4 are
    # layout), and the (rows of 32, padded width) output its contract
    # writes
    px = BATCH * MH * MW
    halo_px = BATCH * (MH + 4) * (MW + 4)
    out_px = BATCH * K6._out_rows(args[0].shape[1]) * args[0].shape[2]
    bd = bound((11 * halo_px + out_px) * 4, RECOMPUTE_OPS * px)
    hp, wp = args[1].shape[2:]
    print(f"[kernels] matvec_recompute (4, 10, {hp}, {wp}) f32: the plain "
          f"version's bits at every shape, valid of ones and with holes; "
          f"within 1e-5 of max|ref| of K3 ({err_k3:.3g}); kernel {ms:.4f} ms "
          f"one launch between events, {b2b:.4f} back to back (strip "
          f"{K6.STRIP}, runs of "
          f"{K6.run_rows(K6._out_rows(hp), wp, BATCH, _sms(dev))} rows), "
          f"plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} ({label})")
    return {"max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None, "ms_back_to_back": b2b}


def check_quantize(label: str, dev) -> dict:
    """K4 on whole-number palettes (the integer path: what the main path
    passes), on fractional ones (the separately rounded float path) and on
    a batch that mixes them image by image, each with exact ties."""
    g = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for b, h, w, k_real in [(BATCH, H4K, W4K, 16), (2, *RAGGED, 11)]:
        rgb = torch.randint(0, 256, (b, h, w, 3), generator=g,
                            dtype=torch.uint8, device=dev)
        alpha = torch.rand((b, h, w), generator=g, device=dev) > 0.3
        whole = torch.randint(0, 256, (b, 16, 3), generator=g,
                              device=dev).to(torch.float32)
        frac = torch.rand((b, 16, 3), generator=g, device=dev) * 255
        mixed = whole.clone()
        mixed[1::2] = frac[1::2]
        thr = torch.tensor([30.0, 10.0, -1.0, 30.0][:b], device=dev)
        for name, pal in (("whole", whole), ("fractional", frac),
                          ("mixed", mixed)):
            pal[:, 5] = pal[:, 2]  # exact ties: the first index must win
            kinds = KQ.whole_number_palette(pal, k_real).tolist()
            want = {"whole": [True] * b, "fractional": [False] * b,
                    "mixed": [i % 2 == 0 for i in range(b)]}[name]
            if kinds != want:
                fail(f"quantize {name}: the palette test says {kinds}")
            ref = KQ.quantize_map_plain(rgb, alpha, pal, k_real, thr)
            if not torch.equal(KQ.quantize_map(rgb, alpha, pal, k_real, thr),
                               ref):
                fail(f"quantize {(b, h, w)} {name} palette: differs from "
                     "plain")
        if h == H4K:
            args = (rgb, alpha, whole, k_real, thr)
            args_frac = (rgb, alpha, frac, k_real, thr)
    ms = median_ms(lambda: KQ.quantize_map(*args))
    ms_frac = median_ms(lambda: KQ.quantize_map(*args_frac))
    b2b = median_ms(lambda: KQ.quantize_map(*args), inner=BACK_TO_BACK)
    b2b_frac = median_ms(lambda: KQ.quantize_map(*args_frac),
                         inner=BACK_TO_BACK)
    plain_ms = median_ms(lambda: KQ.quantize_map_plain(*args))
    # 3 + 1 bytes read and 3 written per pixel, plus the palettes. Per
    # pixel and palette entry 3 subtractions, 3 multiplications, 2
    # additions and a comparison (9 x 16), plus the brightness test (8).
    # That reckoning is the float path's; the integer path does about 3
    # operations an entry, so for it the bytes alone are the floor
    px = BATCH * H4K * W4K
    bd = bound(7 * px + BATCH * 16 * 3 * 4, (9 * 16 + 8) * px)
    bytes_ms = bound(7 * px + BATCH * 16 * 3 * 4, 0)["bound_ms"]
    print(f"[kernels] quantize (4, {H4K}, {W4K}, 3) u8 k=16: bit-exact on "
          f"whole-number, fractional and mixed palettes; kernel on "
          f"whole-number palettes {ms:.4f} ms one launch between events, "
          f"{b2b:.4f} ms back to back; on fractional palettes {ms_frac:.4f} "
          f"and {b2b_frac:.4f} ms; plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} (the float path's "
          f"count; the bytes alone, the integer path's floor, "
          f"{bytes_ms:.4f} ms) ({label})")
    return {"max_abs_err": err, "ms": ms, "ms_fractional": ms_frac,
            "plain_ms": plain_ms, **bd, "bytes_bound_ms": bytes_ms,
            "library_ms": None,
            "ms_back_to_back": b2b, "ms_fractional_back_to_back": b2b_frac}


def check_quantize_flat(label: str, dev) -> dict:
    """K7 against its plain version and against K4 on the same operands,
    on whole-number palettes (K4's integer path), fractional ones and a
    batch that mixes them image by image, each with exact ties: the bench
    shape, a ragged one (the byte path), small ones whose rows are a
    multiple of 16 (the 16-byte path, also with 1 entry and none) and 256
    entries."""
    g = torch.Generator(device=dev).manual_seed(7)
    for b, h, w, k_real in [(BATCH, H4K, W4K, 16), (2, *RAGGED, 11),
                            (3, 48, 50, 16), (4, 48, 50, 1), (2, 16, 16, 0),
                            (2, 64, 100, 256)]:
        k_max = max(16, k_real)
        rgb = torch.randint(0, 256, (b, h, w, 3), generator=g,
                            dtype=torch.uint8, device=dev)
        alpha = torch.rand((b, h, w), generator=g, device=dev) > 0.3
        whole = torch.randint(0, 256, (b, k_max, 3), generator=g,
                              device=dev).to(torch.float32)
        frac = torch.rand((b, k_max, 3), generator=g, device=dev) * 255
        mixed = whole.clone()
        mixed[1::2] = frac[1::2]
        thr = torch.tensor([30.0, 10.0, -1.0, 30.0][:b], device=dev)
        for name, pal in (("whole", whole), ("fractional", frac),
                          ("mixed", mixed)):
            pal[:, 5] = pal[:, 2]  # exact ties: the first index must win
            rgb[:, 0, 0] = pal[:, 2].to(torch.uint8)
            got = K7.quantize_map_flat(rgb, alpha, pal, k_real, thr)
            if not torch.equal(got, K7.quantize_map_flat_plain(
                    rgb, alpha, pal, k_real, thr)):
                fail(f"quantize_flat {(b, h, w)} k {k_real} {name} palette "
                     "differs from plain")
            if not torch.equal(got, KQ.quantize_map(rgb, alpha, pal, k_real,
                                                    thr)):
                fail(f"quantize_flat {(b, h, w)} k {k_real} {name} palette "
                     "differs from K4")
        if h == H4K:
            planes = K7.split_planes(rgb)
            args = (planes, alpha.reshape(b, h * w), whole, k_real, thr)
            args_frac = (planes, alpha.reshape(b, h * w), frac, k_real, thr)
            whole_frame = (rgb, alpha, whole, k_real, thr)
    ms = median_ms(lambda: K7.quantize_planes(*args))
    b2b = median_ms(lambda: K7.quantize_planes(*args), inner=BACK_TO_BACK)
    ms_frac = median_ms(lambda: K7.quantize_planes(*args_frac))
    b2b_frac = median_ms(lambda: K7.quantize_planes(*args_frac),
                         inner=BACK_TO_BACK)
    plain_ms = median_ms(lambda: K7.quantize_planes_plain(*args))
    function_ms = median_ms(lambda: K7.quantize_map_flat(*whole_frame))
    # K4's work: 3 + 1 bytes read and 3 written per pixel, 9 operations
    # per pixel and palette entry and 8 for the brightness test. That
    # reckoning is the float path's; the integer path does about 3
    # operations an entry, so for it the bytes alone are the floor
    px = BATCH * H4K * W4K
    bd = bound(7 * px + BATCH * 16 * 3 * 4, (9 * 16 + 8) * px)
    bytes_ms = bound(7 * px + BATCH * 16 * 3 * 4, 0)["bound_ms"]
    print(f"[kernels] quantize_flat planes (3, 4, {H4K * W4K}) u8 k=16: "
          f"bit-equal to plain and to K4 on whole-number, fractional and "
          f"mixed palettes; kernel on whole-number palettes {ms:.4f} ms one "
          f"launch between events, {b2b:.4f} back to back; on fractional "
          f"palettes {ms_frac:.4f} and {b2b_frac:.4f} ms; with the split "
          f"into planes and the stack back {function_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']} (the float path's count; the bytes alone, the "
          f"integer path's floor, {bytes_ms:.4f} ms) ({label})")
    return {"max_abs_err": 0.0, "ms": ms, "ms_fractional": ms_frac,
            "plain_ms": plain_ms, **bd, "bytes_bound_ms": bytes_ms,
            "library_ms": None, "function_ms": function_ms,
            "ms_back_to_back": b2b, "ms_fractional_back_to_back": b2b_frac}


def check_hist_variants(label: str, dev) -> dict:
    """Every variant of K8 against its plain version, K1 and bincount; one
    device operation a call, 200 calls back to back on changing inputs, a
    second stream; graph times on random, run and alpha-like rows."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randint(0, 256, (BATCH, H4K * W4K), generator=g,
                      dtype=torch.uint8, device=dev)
    x[0, :1 << 20] = 255  # a long run of one value
    cases = {"main": x, "ragged": x[:2, :RAGGED[0] * RAGGED[1]].contiguous(),
             "unaligned": x[1, 1:].reshape(1, -1), "one row": x[:1],
             "all-equal": torch.full((2, MH * MW), 7, dtype=torch.uint8,
                                     device=dev)}
    # the timed inputs: random rows, the same with a run of 2^20 of one
    # value at the head of every row, and the planes the main path counts
    rand = torch.randint(0, 256, (BATCH, H4K * W4K), generator=g,
                         dtype=torch.uint8, device=dev)
    run = rand.clone()
    run[:, :1 << 20] = 255
    alpha = torch.from_numpy(BENCH_K12.alpha_like(
        BATCH, H4K * W4K, np.random.default_rng(8))).to(dev)
    timed = {"random": rand, "run": run, "alpha-like": alpha}
    refs = {name: _bincount(xi).to(torch.float32)
            for name, xi in {**cases, **timed}.items()}
    per_variant = {}
    for variant in K8.STEPS:
        for name, xi in {**cases, **timed}.items():
            got = K8.hist_variant(xi, variant)
            if got.dtype != torch.float32 or got.shape != (xi.shape[0], 256):
                fail(f"hist_variants {variant} {name}: {got.dtype} "
                     f"{tuple(got.shape)}")
            if name in ("ragged", "unaligned", "all-equal"):  # plain's one-hots
                if not torch.equal(got, K8.hist_variant_plain(xi, variant)):
                    fail(f"hist_variants {variant} {name} differs from plain")
            if not torch.equal(got, KH.hist256(xi)):
                fail(f"hist_variants {variant} {name} differs from K1")
            if not torch.equal(got, refs[name]):
                fail(f"hist_variants {variant} {name} differs from bincount")
        # one device operation a call: no memset, no cast
        ops = _device_operations(lambda: K8.hist_variant(x, variant), 10)
        if ops and len(ops) != 10:
            fail(f"hist_variants {variant}: {len(ops)} device operations in "
                 f"10 calls: {sorted(set(ops))}")
        fn = lambda: K8.hist_variant(x, variant)  # noqa: E731
        per_variant[variant] = {
            "ms": median_ms(fn),
            "ms_back_to_back": median_ms(fn, inner=BACK_TO_BACK),
            "ms_one_row": median_ms(lambda: K8.hist_variant(x[:1], variant)),
            "device_operations_per_call": len(ops) / 10 if ops else None,
            **{f"ms_graph_{name}": BENCH_K12.graph_ms(
                lambda: K8.hist_variant(xi, variant), BACK_TO_BACK, REPS)
               for name, xi in timed.items()}}
    if not torch.equal(K8.hist_variant_plain(x, "N3D"), refs["main"]):
        fail("hist_variants: the plain version differs from bincount")

    # 200 calls back to back on changing inputs and variants: the kernel
    # clears K1's scratch itself, and no call may see another's counts
    pool = list({**cases, **timed}.items())
    names = list(K8.STEPS)
    torch.cuda.synchronize()
    outs = [K8.hist_variant(pool[i % len(pool)][1], names[i % len(names)])
            for i in range(200)]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        if not torch.equal(out, refs[pool[i % len(pool)][0]]):
            fail(f"hist_variants: call {i} of 200 back to back differs from "
                 "bincount")
    # a second stream has its own scratch; calls on both overlap
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    outs1, outs2 = [], []
    for i in range(10):
        outs1.append(K8.hist_variant(rand, names[i % len(names)]))
        with torch.cuda.stream(side):
            outs2.append(K8.hist_variant(alpha, names[-1 - i % len(names)]))
    torch.cuda.synchronize()
    if not all(torch.equal(o, refs["random"]) for o in outs1) or \
            not all(torch.equal(o, refs["alpha-like"]) for o in outs2):
        fail("hist_variants: calls on two streams differ from bincount")

    plain_ms = median_ms(lambda: K8.hist_variant_plain(x, "N3D"), reps=3)
    library_ms = median_ms(lambda: _bincount(x))
    k1_ms = median_ms(lambda: KH.hist256(x), inner=BACK_TO_BACK)
    k1_graph = {name: BENCH_K12.graph_ms(lambda: KH.hist256(xi), BACK_TO_BACK,
                                         REPS) for name, xi in timed.items()}
    bd = bound(x.numel() + x.shape[0] * 256 * 4, x.numel())
    bd1 = bound(x.shape[1] + 256 * 4, x.shape[1])
    for variant, t in per_variant.items():
        graphs = ", ".join(f"{name} {t['ms_graph_' + name]:.4f}"
                           for name in timed)
        print(f"[kernels] hist_variants {variant} {tuple(x.shape)} u8: exact "
              f"against plain, K1 and bincount on {len(cases) + len(timed)} "
              f"inputs, over 200 calls back to back and on two streams; "
              f"{t['device_operations_per_call']} device operations a call "
              f"(torch.profiler); from a CUDA graph {graphs} ms (share of "
              f"bound on random {bd['bound_ms'] / t['ms_graph_random']:.2f}); "
              f"{t['ms']:.4f} ms one launch, {t['ms_back_to_back']:.4f} back "
              f"to back (bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}), "
              f"one row {t['ms_one_row']:.4f} ms (bound {bd1['bound_ms']:.4f} "
              f"ms) ({label})")
    print(f"[kernels] hist_variants: K1 on the same rows {k1_ms:.4f} ms back "
          f"to back, from a CUDA graph "
          + ", ".join(f"{name} {ms:.4f}" for name, ms in k1_graph.items())
          + f"; plain (N3D) {plain_ms:.4f} ms, bincount {library_ms:.4f} ms "
          f"({label})")
    n3d = per_variant["N3D"]
    return {"max_abs_err": 0.0, "ms": n3d["ms"],
            "ms_back_to_back": n3d["ms_back_to_back"],
            "ms_graph": n3d["ms_graph_random"], "plain_ms": plain_ms, **bd,
            "library_ms": library_ms, "k1_ms_graph": k1_graph,
            "variants": per_variant}


def _cg_state(loop) -> dict:
    """The CG's loop-carried state, floats as their bits (NaN equals NaN)."""
    out = {"x": loop.x.blocks[0], "r": loop.r.blocks[0],
           "p": loop.p.blocks[0], "rz": loop.rz, "pending": loop.pending,
           "it": loop.it, "active": loop.active, "flag": loop.flag}
    return {k: v.view(torch.int32) if v.dtype == torch.float32 else v
            for k, v in out.items()}


def _cg_parity(dev, b: int, h: int, w: int) -> tuple:
    """Two CGs on the photo mosaic at (b, h, w), rtol 1e-5, one stepped
    through `_step_fused` and one through `_step_plain`, bit for bit after
    every chunk: image 0 as it comes, image 1 with a restart pending,
    image 2 (where there is one) with p = 0 (a breakdown at the noise
    floor, then a restart), the last image with an infinite residual
    entry once 8 iterations have run (it stops at the next, inside a
    chunk). Returns (chunks, iterations of each image)."""
    fused, plain = (MICRO_CG.make_loop(b, h, w, dev, rtol=1e-5, max_iter=200)
                    for _ in range(2))
    if fused.update != "fused":
        fail(f"CGLoop at {(b, h, w)} on the card runs {fused.update!r}, "
             f"not the fused update")
    for loop in (fused, plain):
        if b > 1:
            loop.pending[1] = True
        if b > 2:
            loop.p.blocks[0][2] = 0.0
    hit, chunks = None, 0
    while bool(plain.flag):
        if hit is None and int(plain.it.max()) >= 8:
            hit = int(plain.it[b - 1])
            for loop in (fused, plain):
                loop.r.blocks[0][b - 1, h // 2, w // 3] = float("inf")
        k3, cu = KMV.LAUNCHES, KCG.LAUNCHES
        fused.step()
        launched = (KMV.LAUNCHES - k3, KCG.LAUNCHES - cu)
        plain._step_plain()
        chunks += 1
        if launched != (MAT.CG_CHUNK, 3 * MAT.CG_CHUNK):
            fail(f"a fused CG chunk at {(b, h, w)} launched {launched[0]} "
                 f"K3 and {launched[1]} update kernels, not {MAT.CG_CHUNK} "
                 f"and {3 * MAT.CG_CHUNK}")
        got, want = _cg_state(fused), _cg_state(plain)
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        if differ:
            fail(f"the fused CG at {(b, h, w)} left `_body`'s bits in "
                 f"{differ} after chunk {chunks}")
    it = plain.it.tolist()
    if hit is None or it[b - 1] != hit + 1 or bool(fused.flag):
        fail(f"the CG at {(b, h, w)} did not stop as set up: iterations "
             f"{it}, the infinite entry after {hit}")
    return chunks, it


def check_cg_update(label: str, dev) -> dict:
    """The CG's update against `_body` and the micro's times and bounds."""
    cases = {}
    for shape in ((BATCH, MH, MW), (2, *RAGGED)):
        cases[shape] = _cg_parity(dev, *shape)
    rec = MICRO_CG.run(BATCH, MH, MW)
    if not rec["bits_equal"]:
        fail("micro_cg_iter: the fused and plain graphs' states differ")
    it_ms = rec["iteration_ms"]
    kern = {k.replace("_kernel", ""): v for k, v in rec["kernels"].items()}
    k3 = kern.pop("matvec")
    if any(v["ms"] is None for v in (k3, *kern.values())):
        fail(f"micro_cg_iter: a kernel has no device time: {rec['kernels']}")
    plain_ms = it_ms["plain"] - k3["ms"]  # `_body` outside K3
    ms = sum(v["ms"] for v in kern.values())
    bd = {"bound_ms": sum(v["bound_ms"] for v in kern.values()),
          "bound_by": "bytes"}
    print(f"[kernels] cg_update ({BATCH}, {MH}, {MW}) and {(2, *RAGGED)} "
          f"f32: `_body`'s bits after every chunk ("
          + "; ".join(f"{s}: {c} chunks, iterations {it}"
                      for s, (c, it) in cases.items())
          + "); from a CUDA graph an iteration "
          + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
                      f"{v['share_of_bound']:.2f} of it)"
                      for k, v in kern.items())
          + f", K3 {k3['ms']:.4f}; the iteration fused {it_ms['fused']:.4f} "
          f"ms, plain {it_ms['plain']:.4f} (`_body` outside K3 "
          f"{plain_ms:.4f}) ({label})")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": None, "ms_graph": ms, "kernels": kern,
            "iteration_ms": it_ms}


# ---------------------------------------------------------------------------
# SAM's encoder attention at ViT-H's two shapes: (B', heads, h, w, d)
SAM_ATTN_SHAPES = {"global": (4, 16, 64, 64, 80),
                   "window": (100, 16, 14, 14, 80)}
BF16_OPS = 989e12  # dense bfloat16 tensor-core peak of one H100 SXM


def sam_attn_operands(dev, b, nh, h, w, d, seed):
    """q, k, v as views of one (b, h w, 3 nh d) bfloat16 projection, rel_h
    and rel_w from models/sam.Attention's einsums on random tables, the
    scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h * w, 3 * nh * d, generator=g, device=dev)
    q, k, v = x.to(torch.bfloat16).view(b, h * w, 3, nh, d) \
        .permute(2, 0, 3, 1, 4).unbind(0)
    rh = (0.1 * torch.randn(h, h, d, generator=g, device=dev)) \
        .to(torch.bfloat16)
    rw = (0.1 * torch.randn(w, w, d, generator=g, device=dev)) \
        .to(torch.bfloat16)
    r_q = q.reshape(b * nh, h, w, d)
    return (q, k, v, torch.einsum("bhwc,hkc->bhwk", r_q, rh),
            torch.einsum("bhwc,wkc->bhwk", r_q, rw), d ** -0.5)


def sam_attn_tolerance(ops, ref):
    """How far the kernel may lie from its plain version, elementwise: both
    round the same bias and sum in float32, but each rounds a row's
    unnormalised probabilities to bfloat16 against its own running
    maximum (each within 2^-8 relative, so the two within 2^-7: the
    output within 2^-7 of the row's probability-weighted |v|), and each
    rounds the output to bfloat16 (the two within one unit in the last
    place, 2^-7 of |ref|)."""
    q, k, v, rel_h, rel_w, scale = ops
    wv = KSA.attention_plain(q, k, v.abs(), rel_h, rel_w, scale)
    return 2 ** -7 * (wv.float() + ref.float().abs())


def sam_attn_library(q, k, v, rel_h, rel_w, scale):
    """What the kernel replaced, a yardstick the port never calls: the
    bias formed as a bfloat16 mask (rows padded to 8 keys) and
    F.scaled_dot_product_attention with it, on contiguous q, k, v."""
    import torch.nn.functional as F

    b, nh, n, _ = q.shape
    _, h, w, _ = rel_h.shape
    rows = torch.empty(b * nh, n, -(-n // 8) * 8, dtype=q.dtype,
                       device=q.device)[:, :, :n]
    torch.add(rel_h[:, :, :, :, None], rel_w[:, :, :, None, :],
              out=rows.view(b * nh, h, w, h, w))
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=rows.view(b, nh, n, n), scale=scale)


def check_sam_attention(label: str, dev) -> dict:
    """The kernel against its plain version at ViT-H's two shapes, timed
    one launch, back to back and from a CUDA graph, beside its bound and
    the library path it replaced."""
    rec = {}
    for name, (b, nh, h, w, d) in SAM_ATTN_SHAPES.items():
        ops = sam_attn_operands(dev, b, nh, h, w, d, seed=b)
        q, k, v, rel_h, rel_w, scale = ops
        n = h * w
        got = KSA.attention(*ops)
        ref = KSA.attention_plain(*ops)
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        # tests/test_torch_cuda.py's tolerance: 2^-7 of the row's
        # probability-weighted |v| and of |ref|
        tol = sam_attn_tolerance(ops, ref)
        o_med = float(ref.float().abs().median())
        tol_med = float(tol.median())
        worst = float((diff / tol).max())
        if worst > 1.0:
            fail(f"sam_attention {name}: {err} from the plain version, "
                 f"{worst:.3f} of the tolerance")
        del ref, diff, tol
        lib_ops = (q.contiguous(), k.contiguous(), v.contiguous(), rel_h,
                   rel_w, scale)
        lib = sam_attn_library(*lib_ops)
        lib_err = float((lib.permute(0, 2, 1, 3).reshape(b, n, nh * d)
                         .float() - got.float()).abs().max())
        fn = lambda: KSA.attention(*ops)  # noqa: E731
        ms = median_ms(fn)
        b2b = median_ms(fn, inner=BACK_TO_BACK)
        graph = BENCH_K12.graph_ms(fn, BACK_TO_BACK, REPS)
        plain_ms = median_ms(lambda: KSA.attention_plain(*ops), reps=3)
        library_ms = median_ms(lambda: sam_attn_library(*lib_ops))
        flops = 4.0 * b * nh * n * n * d
        nbytes = 2.0 * (4 * b * n * nh * d + b * nh * n * (h + w))
        t_ops, t_bytes = flops / BF16_OPS * 1e3, nbytes / HBM_BPS * 1e3
        bd = {"bound_ms": max(t_ops, t_bytes),
              "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        rec[name] = {"max_abs_err": err, "err_over_tol": worst,
                     "library_err": lib_err, "ms": ms,
                     "ms_back_to_back": b2b, "ms_graph": graph,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "tflops_graph": flops / graph / 1e9, **bd}
        print(f"[kernels] sam_attention {name} ({b}, {nh}, {n}, {d}) grid "
              f"{h} x {w} bf16: {err:.5f} from plain, at most {worst:.3f} "
              f"of the tolerance (median tolerance {tol_med:.5f}, median "
              f"|o| {o_med:.5f}; the library path {lib_err:.5f} from the "
              f"kernel); "
              f"{ms:.4f} ms one launch, {b2b:.4f} back to back, {graph:.4f} "
              f"from a CUDA graph ({flops / graph / 1e9:.1f} TFLOP/s), "
              f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({bd['bound_ms'] / graph:.3f} of it); plain {plain_ms:.3f} "
              f"ms; bias add + SDPA {library_ms:.4f} ms ({label})")
        del lib, got
    torch.cuda.empty_cache()
    g = rec["global"]
    return {**{k: g[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "ms_graph")},
            "ms_back_to_back": g["ms_back_to_back"], "shapes": rec}


# ---------------------------------------------------------------------------
# BiRefNet's Swin-L stages at its 4 x 1024 x 1024 input and at the half-size
# copy: (grid side, heads, blocks), every second block shifted by 6
SWIN_STAGES = ((256, 6, 2), (128, 12, 2), (64, 24, 18), (32, 48, 2),
               (128, 6, 2), (64, 12, 2), (32, 24, 18), (16, 48, 2))
SWIN_SHIFTS = (0, 6)


def swin_attn_operands(dev, b, side, heads, shift, seed):
    """A block's qkv projection (b, side, side, 3C) bfloat16 and its bias,
    N(0, 1); a models/birefnet.WindowAttention holding a N(0, 1) table (as
    seeded_init draws it); its mask for the plain version; the scale."""
    from image_segmenter_tpu_torch.models import birefnet as BRN

    g = torch.Generator(device=dev).manual_seed(seed)
    c = heads * KSW.HEAD_DIM
    qkv = torch.randn(b, side, side, 3 * c, generator=g, device=dev).to(
        torch.bfloat16)
    bias = torch.randn(3 * c, generator=g, device=dev).to(torch.bfloat16)
    attn = BRN.WindowAttention(c, KSW.WINDOW, heads).to(dev)
    with torch.no_grad():
        attn.relative_position_bias_table.normal_(generator=g)
    hp = -(-side // KSW.WINDOW) * KSW.WINDOW
    mask = attn.mask(hp, hp, shift, torch.bfloat16, dev)
    return qkv, bias, attn.relative_position_bias_table.detach(), mask, \
        attn.scale


def swin_attn_tolerance(qkv, bias, mask, shift, scale, ref):
    """How far the kernel may lie from its plain version, elementwise: both
    round the same bias and sum in float32, but each rounds a row's
    unnormalised probabilities to bfloat16 (SDPA against its running
    maximum), so the two within 2^-7 of the row's probability-weighted
    |v|, and each rounds the output to bfloat16 (one unit in the last
    place, within 2^-7 of |ref|)."""
    c = qkv.shape[-1] // 3
    qa, ba = qkv.clone(), bias.clone()
    qa[..., 2 * c:] = qa[..., 2 * c:].abs()
    ba[2 * c:] = ba[2 * c:].abs()
    wv = KSW.attention_plain(qa, ba, mask, shift, scale)
    return 2 ** -7 * (wv.float() + ref.float().abs())


def swin_attn_bound(b, side, heads) -> dict:
    """The products on the padded grid (q k^T and P v, 4 d flops a score)
    at the bf16 rate, or qkv read and the output written once at the
    memory's."""
    hp = -(-side // KSW.WINDOW) * KSW.WINDOW
    c = heads * KSW.HEAD_DIM
    flops = 4.0 * KSW.HEAD_DIM * b * hp * hp * heads * KSW.WINDOW ** 2
    nbytes = 2.0 * b * side * side * 4 * c
    t_ops, t_bytes = flops / BF16_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_swin_attention(label: str, dev) -> dict:
    """The kernel against its plain version (pad rows from the bias, roll,
    partition, SDPA with the materialised mask, reverse, roll back, crop:
    the parent's path) at every grid of Swin-L's stages in a BiRefNet call,
    shift 0 and 6, batch 4, timed one launch, back to back and from a CUDA
    graph beside its bound and beside the plain version; then a call's 48
    launches summed."""
    rec = {}
    for side, heads, _ in SWIN_STAGES:
        for shift in SWIN_SHIFTS:
            name = f"{side}x{side}_h{heads}_s{shift}"
            if name in rec:
                continue
            qkv, bias, table, mask, scale = swin_attn_operands(
                dev, BATCH, side, heads, shift, seed=side + heads + shift)
            n0 = KSW.LAUNCHES
            got = KSW.attention(qkv, bias, table, shift, scale)
            if KSW.LAUNCHES != n0 + 1:
                fail(f"swin_attention {name}: {KSW.LAUNCHES - n0} launches")
            ref = KSW.attention_plain(qkv, bias, mask, shift, scale)
            diff = (got.float() - ref.float()).abs()
            tol = swin_attn_tolerance(qkv, bias, mask, shift, scale, ref)
            worst = float((diff / tol).max())
            err = float(diff.max())
            if worst > 1.0 or not bool(torch.isfinite(got).all()):
                fail(f"swin_attention {name}: {err} from the plain version, "
                     f"{worst:.3f} of the tolerance")
            del ref, diff, tol
            fn = lambda: KSW.attention(qkv, bias, table, shift,  # noqa: E731
                                       scale)
            ms = median_ms(fn)
            b2b = median_ms(fn, inner=BACK_TO_BACK)
            graph = BENCH_K12.graph_ms(fn, BACK_TO_BACK, REPS)
            plain_ms = median_ms(lambda: KSW.attention_plain(
                qkv, bias, mask, shift, scale), reps=3)
            bd = swin_attn_bound(BATCH, side, heads)
            rec[name] = {"max_abs_err": err, "err_over_tol": worst,
                         "ms": ms, "ms_back_to_back": b2b,
                         "ms_graph": graph, "plain_ms": plain_ms,
                         "tflops_graph": bd["flops"] / graph / 1e9, **bd}
            print(f"[kernels] swin_attention ({BATCH}, {side}, {side}, "
                  f"{3 * heads * KSW.HEAD_DIM}) heads {heads} shift {shift}: "
                  f"{err:.5f} from plain, at most {worst:.3f} of the "
                  f"tolerance; {ms:.4f} ms one launch, {b2b:.4f} back to "
                  f"back, {graph:.4f} from a CUDA graph "
                  f"({bd['flops'] / graph / 1e9:.1f} TFLOP/s, "
                  f"{bd['bytes'] / graph / 1e6:.1f} GB/s), bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"({bd['bound_ms'] / graph:.3f} of it); plain (the "
                  f"parent's path: SDPA on the materialised mask) "
                  f"{plain_ms:.4f} ms ({label})")
            del qkv, bias, table, mask, got
    torch.cuda.empty_cache()
    # a call's 48 launches: each stage's blocks, half of them shifted
    call = [rec[f"{side}x{side}_h{heads}_s{shift}"]
            for side, heads, blocks in SWIN_STAGES
            for shift in SWIN_SHIFTS for _ in range(blocks // 2)]
    total = {key: sum(r[key] for r in call)
             for key in ("ms", "ms_back_to_back", "ms_graph", "plain_ms",
                         "bound_ms", "flops", "bytes")}
    print(f"[kernels] swin_attention, a BiRefNet call's {len(call)} launches "
          f"(batch 4 at 1024 x 1024): {total['ms_graph']:.4f} ms from a CUDA "
          f"graph against {total['bound_ms']:.4f} ms bound "
          f"({total['bound_ms'] / total['ms_graph']:.3f} of it; "
          f"{total['bytes'] / 1e9:.3f} GB, {total['flops'] / 1e9:.1f} "
          f"GFLOP), plain {total['plain_ms']:.3f} ms ({label})")
    return {"max_abs_err": max(r["max_abs_err"] for r in rec.values()),
            **{k: total[k] for k in ("ms", "ms_back_to_back", "ms_graph",
                                     "plain_ms", "bound_ms")},
            "bound_by": "bytes", "library_ms": total["plain_ms"],
            "shapes": rec}


# ---------------------------------------------------------------------------
# the resizes of a 4 x 2160 x 3840 batch: (name, source, destination,
# method, channels); U2-Netp's five, ISNet's Lanczos to and from 1024 x
# 1024, SAM's BILINEAR_PIL to 576 x 1024
RESAMPLES = (("cnn_in", (H4K, W4K), (320, 320), "lanczos_pil", 3),
             ("mask_up", (320, 320), (H4K, W4K), "lanczos_pil", 1),
             ("rgb_shrink", (H4K, W4K), (MH, MW), "area", 3),
             ("alpha_shrink", (H4K, W4K), (MH, MW), "area", 1),
             ("alpha_up", (MH, MW), (H4K, W4K), "linear", 1),
             ("isnet_in", (H4K, W4K), (1024, 1024), "lanczos_pil", 3),
             ("isnet_up", (1024, 1024), (H4K, W4K), "lanczos_pil", 1),
             ("sam_in", (H4K, W4K), (MH, MW), "bilinear_pil", 3))
CELL1_RESAMPLES = ("cnn_in", "mask_up", "rgb_shrink", "alpha_shrink",
                   "alpha_up")
F64_OPS = 34e12  # float64 outside the tensor cores, one H100 SXM


def resample_bound(b, src, dst, method, c) -> dict:
    """The least time of a resize: its u8 read and written once at the
    memory rate, or a multiply and an add for each nonzero tap of the two
    passes (rows over every source column, columns over every output
    row) at the float64 rate, whichever is larger."""
    (h, w), (dh, dw) = src, dst
    nz_y = int((RZ._weights(h, dh, method) != 0).sum())
    nz_x = int((RZ._weights(w, dw, method) != 0).sum())
    ops = 2.0 * b * c * (w * nz_y + dh * nz_x)
    nbytes = float(b * c * (h * w + dh * dw))
    t_ops, t_bytes = ops / F64_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_resample(label: str, dev) -> dict:
    """The resize kernel against the dense float64 contraction at the 4K
    path's eight resizes, byte for byte, timed one launch, back to back
    and from a CUDA graph beside its bound and the dense path's time."""
    photos = torch.from_numpy(photo_batch(BATCH, H4K, W4K, seed=0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(25)
    rec = {}
    for name, src, dst, method, c in RESAMPLES:
        if src == (H4K, W4K):
            x = photos if c == 3 else photos[..., 1].contiguous()
        else:
            x = torch.randint(0, 256, (BATCH, *src, c)[:4 if c > 1 else 3],
                              generator=g, device=dev, dtype=torch.uint8)
        fn = lambda: RZ.resize_u8(x, dst, method)  # noqa: E731
        plain = lambda: RZ.resize_u8_plain(x, dst, method)  # noqa: E731
        n0 = KRS.LAUNCHES
        got = fn()
        if KRS.LAUNCHES != n0 + 1:
            fail(f"resample {name}: {KRS.LAUNCHES - n0} launches, not 1")
        diff = int((got != plain()).sum())
        if diff:
            fail(f"resample {name}: {diff} bytes differ from the dense "
                 f"contraction")
        ms = median_ms(fn)
        b2b = median_ms(fn, inner=BACK_TO_BACK)
        graph = BENCH_K12.graph_ms(fn, BACK_TO_BACK, REPS)
        plain_ms = median_ms(plain, reps=3)
        bd = resample_bound(BATCH, src, dst, method, c)
        rec[name] = {"max_abs_err": 0.0, "ms": ms, "ms_back_to_back": b2b,
                     "ms_graph": graph, "plain_ms": plain_ms, **bd}
        print(f"[kernels] resample {name} {method} ({BATCH}, {src[0]}, "
              f"{src[1]}, {c}) -> {dst}: the dense bytes; {ms:.4f} ms one "
              f"launch, {b2b:.4f} back to back, {graph:.4f} from a CUDA "
              f"graph, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({bd['bound_ms'] / graph:.3f} of it); dense {plain_ms:.3f} "
              f"ms ({label})")
        del x, got
    total = {k: sum(rec[n][k] for n in CELL1_RESAMPLES)
             for k in ("ms", "ms_back_to_back", "ms_graph", "plain_ms",
                       "bound_ms")}
    print(f"[kernels] resample, U2-Netp's five resizes of a 4K batch: "
          f"{total['ms_graph']:.4f} ms from a CUDA graph against "
          f"{total['bound_ms']:.4f} ms bound "
          f"({total['bound_ms'] / total['ms_graph']:.3f} of it), dense "
          f"{total['plain_ms']:.3f} ms ({label})")
    torch.cuda.empty_cache()
    by = sorted({rec[n]["bound_by"] for n in CELL1_RESAMPLES})
    return {"max_abs_err": 0.0, **total, "bound_by": " and ".join(by),
            "library_ms": None, "shapes": rec}


# ---------------------------------------------------------------------------
# BiRefNet's deformable convolutions: (H, W) of the decoder's scales at
# 1024 x 1024 (the squeeze block and decoder block 4 share 32 x 32) and
# the branches' kernels, batch 4
DEFORM_SIZES = (32, 64, 128, 256)
DEFORM_KERNELS = (1, 3, 7)


def deform_operands(dev, b, h, w, k, seed):
    """x (B, 64, H, W) bfloat16 channels-last; offsets N(0, 2^2) pixels,
    one tap in 16 thrown 2 to 6 sizes away (outside the image); the
    modulator uniform in (0, 2); the folded weight (256, k, k, 64)
    bfloat16 and bias, as models/birefnet.py hands them over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn(b, 64, h, w, generator=g, device=dev).to(
        torch.bfloat16, memory_format=cl)
    off = 2.0 * torch.randn(b, 2 * k * k, h, w, generator=g, device=dev)
    far = torch.rand(b, 2 * k * k, h, w, generator=g, device=dev) < 1 / 16
    off = torch.where(far, off.sign() * (2 + 4 * torch.rand(
        off.shape, generator=g, device=dev)) * max(h, w), off)
    mask = 2.0 * torch.rand(b, k * k, h, w, generator=g, device=dev)
    wt = (torch.randn(256, k, k, 64, generator=g, device=dev)
          / (8.0 * k)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(256, generator=g, device=dev)
    return (x, off.contiguous(memory_format=cl),
            mask.contiguous(memory_format=cl), wt, bias)


def deform_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """How far the kernel may lie from its plain version: both make the
    same bfloat16 operand of samples and sum its products with the
    weight in float32 in other orders (within 2^-12 of the largest
    output here), and each rounds its result to bfloat16 (the two within
    one unit in the last place, 2^-8 of |ref|, and 2^-7 allows a rounding
    on either side)."""
    r = ref.float().abs()
    return 2 ** -7 * r + 2 ** -12 * float(r.max())


def check_deform_conv(label: str, dev) -> dict:
    """The kernel against its plain version at every published shape of
    BiRefNet's decoder (k 1, 3, 7 at 32, 64, 128 and 256 square, batch 4;
    a ReLU and a bias as the folded branches use them, and a launch into
    a channel slice of a wider tensor, as the branches write their
    concatenation), timed one launch, back to back and from a CUDA graph
    beside its bound (yardstick/birefnet_flops: the products at the bf16
    rate, or the input, offsets, modulators, weight and output once at
    the memory's)."""
    from benchmark.yardstick import birefnet_flops as BRF

    rec = {}
    for hw in DEFORM_SIZES:
        for k in DEFORM_KERNELS:
            name = f"{hw}x{hw}_k{k}"
            ops = deform_operands(dev, BATCH, hw, hw, k, seed=hw + k)
            x, off, mask, wt, bias = ops
            n0 = KDC.LAUNCHES
            got = KDC.deform_conv(x, off, mask, wt, bias, relu=True)
            if KDC.LAUNCHES != n0 + 1:
                fail(f"deform_conv {name}: {KDC.LAUNCHES - n0} launches")
            ref = KDC.deform_conv_plain(x, off, mask, wt, bias, relu=True,
                                        rows=16)
            diff = (got.float() - ref.float()).abs()
            worst = float((diff / deform_tolerance(ref)).max())
            err = float(diff.max())
            if worst > 1.0 or not bool(torch.isfinite(got).all()):
                fail(f"deform_conv {name}: {err} from the plain version, "
                     f"{worst:.3f} of the tolerance")
            # into a channel slice of a (B, 1280, H, W) concatenation
            cat = torch.zeros((BATCH, 1280, hw, hw), dtype=torch.bfloat16,
                              device=dev).to(memory_format=torch.channels_last)
            KDC.deform_conv(x, off, mask, wt, bias, relu=True,
                            out=cat[:, 512:768])
            if not (torch.equal(cat[:, 512:768], got)
                    and not bool(cat[:, :512].any())
                    and not bool(cat[:, 768:].any())):
                fail(f"deform_conv {name}: the launch into a channel slice "
                     f"differs from the plain launch or writes outside it")
            del ref, diff, cat
            fn = lambda: KDC.deform_conv(x, off, mask, wt, bias,  # noqa: E731
                                         relu=True)
            ms = median_ms(fn)
            b2b = median_ms(fn, inner=BACK_TO_BACK)
            graph = BENCH_K12.graph_ms(fn, BACK_TO_BACK, REPS)
            plain_ms = median_ms(lambda: KDC.deform_conv_plain(
                x, off, mask, wt, bias, relu=True, rows=16), reps=2)
            fl = BRF.deform_flops(BATCH, hw, hw, k)
            nb = BRF.deform_bytes(BATCH, hw, hw, k)
            t_ops, t_bytes = fl / BF16_OPS * 1e3, nb / HBM_BPS * 1e3
            bd = {"bound_ms": max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            rec[name] = {"max_abs_err": err, "err_over_tol": worst,
                         "ms": ms, "ms_back_to_back": b2b,
                         "ms_graph": graph, "plain_ms": plain_ms,
                         "tflops_graph": fl / graph / 1e9, **bd}
            print(f"[kernels] deform_conv ({BATCH}, 64, {hw}, {hw}) k {k} "
                  f"-> 256: {err:.5f} from plain, at most {worst:.3f} of "
                  f"the tolerance; {ms:.4f} ms one launch, {b2b:.4f} back "
                  f"to back, {graph:.4f} from a CUDA graph "
                  f"({fl / graph / 1e9:.1f} TFLOP/s), bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"({bd['bound_ms'] / graph:.3f} of it); plain "
                  f"{plain_ms:.3f} ms ({label})")
            del x, off, mask, wt, bias, got
    torch.cuda.empty_cache()
    # a call's 20 launches: the squeeze block and decoder block 4 at 32,
    # blocks 3, 2, 1 at 64, 128, 256; each k 1 twice, 3 and 7
    per = {hw: [rec[f"{hw}x{hw}_k{k}"] for k in (1, 1, 3, 7)]
           for hw in DEFORM_SIZES}
    call = [r for hw in (32, 32, 64, 128, 256) for r in per[hw]]
    total = {key: sum(r[key] for r in call)
             for key in ("ms", "ms_back_to_back", "ms_graph", "plain_ms",
                         "bound_ms")}
    print(f"[kernels] deform_conv, a BiRefNet call's 20 launches (batch 4 "
          f"at 1024 x 1024): {total['ms_graph']:.4f} ms from a CUDA graph "
          f"against {total['bound_ms']:.4f} ms bound "
          f"({total['bound_ms'] / total['ms_graph']:.3f} of it), plain "
          f"{total['plain_ms']:.3f} ms ({label})")
    return {"max_abs_err": max(r["max_abs_err"] for r in rec.values()),
            **total, "bound_by": "operations and bytes", "library_ms": None,
            "shapes": rec}


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


SECOND_SHAPE = (2, 1080, 1920)  # phase 4's second program


def _walls(fn, n: int) -> list:
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def run_slice(label: str):
    """Phase 4; returns the launches and image 0 of the RGBA output.

    `Pipeline.run` is the compiled run: its first call warms up and
    captures the program of the shape (CUDA graphs), every later call
    replays it. It is held to MAIN_PATH_SHA256, to the eager stages'
    bytes and loop counts on the same batch, and its launches are counted
    from the replays."""
    imgs = photo_batch(BATCH, H4K, W4K, seed=0)
    pipe = Pipeline(model="u2netp", k=16, device="cuda")
    x = torch.from_numpy(imgs).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe.run(x)  # warm-up and capture
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    (prog,) = pipe.programs.values()
    torch.cuda.reset_peak_memory_stats()
    pipe.run_eager(x)
    torch.cuda.synchronize()
    peak_eager = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] first call (warm-up and capture of the program): "
          f"{t_capture:.3f} s; peak memory allocated {peak:.3f} GiB, "
          f"reserved after it (the program's pool included) "
          f"{reserved:.3f} GiB; an eager run's peak {peak_eager:.3f} GiB "
          f"({label})")

    zero_counts()
    out = pipe.run(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if k in SLICE_PATH}
    cg_it, lloyd_it = prog.iterations()
    print(f"[slice] kernel launches in one Pipeline.run (from the replays): "
          f"{launches}; CG iterations {cg_it.tolist()}, Lloyd iterations "
          f"{lloyd_it.tolist()}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the main path")
    # one histogram for the trimap's two quantiles and one for Otsu; one
    # precompute and one palette map a batch; K3 once for the first
    # residual and CG_CHUNK times in each chunk the loop replayed; the CG's
    # update three times for each of those K3 launches; one resize each
    # for the CNN's input and its mask, the matting's two shrinks and its
    # alpha back
    chunks = -(-int(cg_it.max()) // MAT.CG_CHUNK)
    want = {"histogram": 2, "precompute": 1,
            "matvec": 1 + MAT.CG_CHUNK * chunks, "quantize": 1,
            "cg_update": 3 * MAT.CG_CHUNK * chunks, "resample": 5}
    if launches != want:
        fail(f"the main path's launches a run are {launches}, not {want}")

    check_output(out, 16, BATCH, H4K, W4K)
    sha = {name: BENCH_K12._sha(t) for name, t in zip(out._fields, out)}
    print(f"[slice] sha256 of the outputs: {sha}")
    if sha != MAIN_PATH_SHA256:
        fail(f"the main path's outputs changed: {sha}, expected "
             f"{MAIN_PATH_SHA256}")

    # the same call traced: its spans (utils/profiling.py) change no byte
    PROF.clear()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]):
        traced = pipe.run(x)
        torch.cuda.synchronize()
    sha_traced = {name: BENCH_K12._sha(t)
                  for name, t in zip(traced._fields, traced)}
    if sha_traced != MAIN_PATH_SHA256:
        fail(f"the main path's outputs changed under the profiler: "
             f"{sha_traced}")
    calls = [c for c in PROF.record().calls
             if c.spans[0].name == "pipeline.run"]
    if len(calls) != 1 or calls[0].chunks.get("CGLoop") != chunks:
        fail(f"the traced call's record is not one call of {chunks} CG "
             f"chunks: {[(c.id, c.chunks) for c in calls]}")
    print(f"[slice] a traced call: sha256 held; {len(calls[0].spans)} spans, "
          f"{calls[0].flag_reads} flag reads, {calls[0].graph_replays} graph "
          f"replays, chunks {calls[0].chunks}")

    loops = []
    eager = drive(SEG.batch_program(pipe.stages, pipe.session.module, x),
                  loops)
    if not all(torch.equal(a, b) for a, b in zip(out, eager)):
        fail("the compiled run's bytes are not the eager stages'")
    if not (torch.equal(cg_it, loops[0].it)
            and torch.equal(lloyd_it, loops[1].it)):
        fail(f"the compiled run's loop counts {cg_it.tolist()} "
             f"{lloyd_it.tolist()} are not the eager stages' "
             f"{loops[0].it.tolist()} {loops[1].it.tolist()}")
    keep = [t.clone() for t in out]
    other = pipe.run(torch.flip(x, dims=[0]))
    if not all(torch.equal(a, b) for a, b in zip(out, keep)):
        fail("a second call changed the first call's outputs")
    if torch.equal(other.alpha, out.alpha):
        fail("a call on other images gave the first call's alpha")
    again = pipe.run(x)
    for a, b in zip(out, again):
        if not torch.equal(a, b):
            fail("a second run is not bit-identical")
    print("[slice] compiled run: the eager stages' bytes and loop counts; "
          "a call on the batch reversed left the first outputs alone; a "
          "third call bit-identical")

    walls = _walls(lambda: pipe.run(x), 5)
    eager_walls = _walls(lambda: pipe.run_eager(x), 3)
    wall = statistics.median(walls)
    mp = BATCH * H4K * W4K / 1e6
    print(f"[slice] Pipeline(u2netp, k=16) {BATCH}x{H4K}x{W4K}: outputs ok; "
          f"compiled {wall * 1e3:.3f} ms/batch (median of {len(walls)}: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in walls)}), "
          f"{mp / wall:.3f} MP/s device-resident; eager stages "
          f"{statistics.median(eager_walls) * 1e3:.3f} ms/batch (median of "
          f"{len(eager_walls)}: "
          f"{', '.join(f'{t * 1e3:.3f}' for t in eager_walls)}) ({label})")
    ops, intervals = PROF.capture_device_timeline(lambda: pipe.run(x))
    busy = PROF.busy_us(intervals) / 1e3
    print(f"[slice] compiled run under the profiler: {len(intervals)} device "
          f"operations, device busy {busy:.3f} ms, idle share against the "
          f"unprofiled median {1.0 - busy / (wall * 1e3):.4f} ({label})")

    y = torch.from_numpy(photo_batch(*SECOND_SHAPE, seed=3)).to("cuda")
    got = pipe.run(y)
    if len(pipe.programs) != 2:
        fail(f"a second shape did not make a program of its own: "
             f"{list(pipe.programs)}")
    if not all(torch.equal(a, b) for a, b in zip(got, pipe.run_eager(y))):
        fail(f"the compiled run at {SECOND_SHAPE} is not the eager stages'")
    if not all(torch.equal(a, b) for a, b in zip(pipe.run(x), out)):
        fail("the first shape's program changed after the second's capture")
    print(f"[slice] a second shape {SECOND_SHAPE}: its own program, the "
          f"eager stages' bytes; the first program unchanged")

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
    print(f"[slice] eager stages ms: cnn {(t[1] - t[0]) * 1e3:.3f}, matting "
          f"{(t[2] - t[1]) * 1e3:.3f} ({KMV.LAUNCHES - mv0} matvec launches), "
          f"quantize {(t[3] - t[2]) * 1e3:.3f} ({label})")
    return launches, out[0][0].cpu().numpy()


# one (x0, y0, x1, y1) box a frame of the slice's batch: whole 1080 tiles,
# as the SAM cell's traffic draws them, and one across tiles
SAM_BOXES = ((0, 0, 1079, 1079), (1080, 1080, 2159, 2159),
             (2160, 0, 3239, 1079), (1500, 700, 3100, 2000))


def run_sam_slice(label: str) -> dict:
    """Phase 4, SAM: Pipeline(model="sam_vit_h", k=16).run on phase 4's
    batch with one box a frame, the SAM cell's path. The first call
    captures the program; the launches of one replayed call are counted
    after zero_counts(), as for the CNN. Returns them."""
    from image_segmenter_tpu_torch.models import sam as SAM

    x = torch.from_numpy(photo_batch(BATCH, H4K, W4K, seed=0)).to("cuda")
    boxes = np.asarray(SAM_BOXES, np.float32)
    pipe = Pipeline(model="sam_vit_h", k=16, device="cuda")
    depth = pipe.session.module.cfg.depth
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(x, boxes)  # warm-up and capture
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0

    zero_counts()
    frames0 = SAM.FRAMES
    out = pipe.run(x, boxes)
    torch.cuda.synchronize()
    launches = read_counts()
    print(f"[sam] first call (warm-up and capture): {t_capture:.3f} s; "
          f"kernel launches in one Pipeline.run (from the replays): "
          f"{launches}; frames {SAM.FRAMES - frames0} ({label})")
    if launches["sam_attention"] != depth:
        fail(f"the SAM path launched the attention kernel "
             f"{launches['sam_attention']} times a call, not {depth} (one "
             f"a block)")
    # the encoder's input, the matting's two shrinks and its alpha back
    if launches["resample"] != 4:
        fail(f"the SAM path launched the resize kernel "
             f"{launches['resample']} times a call, not 4")
    for name in SLICE_PATH:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the SAM path")
    if SAM.FRAMES - frames0 != BATCH:
        fail(f"a replay counted {SAM.FRAMES - frames0} frames, not {BATCH}")

    check_output(out, 16, BATCH, H4K, W4K)
    if out.logits.shape[0] != BATCH or not bool(
            torch.isfinite(out.logits).all() & torch.isfinite(out.iou).all()):
        fail(f"SAM's logits {tuple(out.logits.shape)} or IoU are not "
             f"finite")
    every = lambda o: (*o, o.logits, o.iou)  # noqa: E731
    keep = [t.clone() for t in every(out)]
    if not all(torch.equal(a, b)
               for a, b in zip(keep, every(pipe.run(x, boxes)))):
        fail("a second SAM replay is not bit-identical")
    if not all(torch.equal(a, b)
               for a, b in zip(keep, every(pipe.run_eager(x, boxes)))):
        fail("the compiled SAM run's bytes are not the eager run's")
    walls = _walls(lambda: pipe.run(x, boxes), 5)
    wall = statistics.median(walls)
    print(f"[sam] Pipeline(sam_vit_h, k=16) {BATCH}x{H4K}x{W4K}, a box a "
          f"frame: outputs ok, the eager run's bytes, a second replay "
          f"bit-identical; compiled {wall * 1e3:.3f} ms/batch (median of "
          f"{len(walls)}: {', '.join(f'{t * 1e3:.3f}' for t in walls)}), "
          f"{BATCH * H4K * W4K / 1e6 / wall:.3f} MP/s device-resident "
          f"({label})")
    del pipe, out, keep
    torch.cuda.empty_cache()
    return launches


# the largest worst-frame ||logits - ref|| / ||ref|| of BiRefNet's bfloat16
# network against its float32 reference at published widths, set between
# the two readings on the H100: the program 0.0031, the float8 control
# 0.045-0.048 (about 4x room on each side)
BIREFNET_LOGIT_REL = 0.012


def run_birefnet_slice(label: str) -> dict:
    """Phase 4, BiRefNet: Pipeline(model="birefnet-general", k=16).run on
    phase 4's batch, the BiRefNet cell's path. The first call captures the
    program; the launches of one replayed call are counted after
    zero_counts(), as for the CNN: the deformable kernel 20 times (five
    blocks of four branches), the window attention 48 (one a Swin block,
    24 at each of two scales), the resize 5. The network's input and
    logits in that replayed call are the captured graph's own tensors,
    kept by a forward hook on the session's module at capture; they are
    held against reference/birefnet_plain.py in float32 on the card,
    frame by frame, as `logit_rel`, with the float8 control beside it.
    Returns the launches."""
    from benchmark.reference import birefnet_plain as BP
    from image_segmenter_tpu_torch.models import birefnet as BRN

    x = torch.from_numpy(photo_batch(BATCH, H4K, W4K, seed=0)).to("cuda")
    pipe = Pipeline(model="birefnet-general", k=16, device="cuda")
    module = pipe.session.module
    captured = {}

    def keep(mod, args, result):
        # a tensor held from the capture keeps its block of the graph's
        # pool, which each replay writes
        if torch.cuda.is_current_stream_capturing():
            captured["x"], captured["logits"] = args[0], result[0]

    hook = module.register_forward_hook(keep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(x)  # warm-up and capture
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    hook.remove()
    if set(captured) != {"x", "logits"}:
        fail("the BiRefNet network stage was not captured")

    zero_counts()
    frames0 = BRN.FRAMES
    out = pipe.run(x)
    torch.cuda.synchronize()
    launches = read_counts()
    # the replayed call's network input and logits
    xin = captured["x"].float().clone()
    logits = captured["logits"].float().clone()
    print(f"[birefnet] first call (warm-up and capture): {t_capture:.3f} s; "
          f"kernel launches in one Pipeline.run (from the replays): "
          f"{launches}; frames {BRN.FRAMES - frames0} ({label})")
    if launches["deform_conv"] != 20:
        fail(f"the BiRefNet path launched the deformable kernel "
             f"{launches['deform_conv']} times a call, not 20")
    if launches["resample"] != 5:
        fail(f"the BiRefNet path launched the resize kernel "
             f"{launches['resample']} times a call, not 5")
    if launches["swin_attention"] != 48:
        fail(f"the BiRefNet path launched the window attention kernel "
             f"{launches['swin_attention']} times a call, not 48 (one a "
             f"Swin block, 24 at each of two scales)")
    for name in SLICE_PATH:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the BiRefNet path")
    if BRN.FRAMES - frames0 != BATCH:
        fail(f"a replay counted {BRN.FRAMES - frames0} frames, not {BATCH}")
    check_output(out, 16, BATCH, H4K, W4K)
    keep = [t.clone() for t in out]
    if not all(torch.equal(a, b) for a, b in zip(keep, pipe.run(x))):
        fail("a second BiRefNet replay is not bit-identical")
    if not all(torch.equal(a, b) for a, b in zip(keep, pipe.run_eager(x))):
        fail("the compiled BiRefNet run's bytes are not the eager run's")
    walls = _walls(lambda: pipe.run(x), 5)
    wall = statistics.median(walls)
    print(f"[birefnet] Pipeline(birefnet-general, k=16) {BATCH}x{H4K}x{W4K}:"
          f" outputs ok, the eager run's bytes, a second replay "
          f"bit-identical; compiled {wall * 1e3:.3f} ms/batch (median of "
          f"{len(walls)}: {', '.join(f'{t * 1e3:.3f}' for t in walls)}), "
          f"{BATCH * H4K * W4K / 1e6 / wall:.3f} MP/s device-resident "
          f"({label})")

    with torch.device("meta"):
        ref = BP.BiRefNetPlain()
    ref.load_state_dict(module.state_dict(), strict=True, assign=True)
    with torch.no_grad():
        want = [ref(xin[i:i + 1]) for i in range(BATCH)]
        ref.set("fp8")
        ctrl = [ref(xin[i:i + 1]) for i in range(BATCH)]
    rel = {"f32": [float((logits[i:i + 1] - w).norm() / w.norm())
                   for i, w in enumerate(want)],
           "fp8": [float((c - w).norm() / w.norm())
                   for c, w in zip(ctrl, want)]}
    logit_rel = max(rel["f32"])
    print(f"[birefnet] logit_rel, the replayed network's logits against "
          f"birefnet_plain (float32, TF32 off) at published widths, frame "
          f"by frame: {', '.join(f'{v:.5f}' for v in rel['f32'])} (limit "
          f"{BIREFNET_LOGIT_REL}); the float8 control against the same: "
          f"{', '.join(f'{v:.5f}' for v in rel['fp8'])} ({label})")
    if logit_rel > BIREFNET_LOGIT_REL or \
            min(rel["fp8"]) <= BIREFNET_LOGIT_REL:
        fail(f"BiRefNet's logits lie {logit_rel} from the reference (limit "
             f"{BIREFNET_LOGIT_REL}; the control {min(rel['fp8'])})")
    del pipe, module, out, keep, ref, captured, xin, logits
    torch.cuda.empty_cache()
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
    pipeline_card_vs_cpu(photo_batch(b, h, w, seed=1), "card-vs-cpu", label)


def pipeline_card_vs_cpu(img: np.ndarray, tag: str, label: str) -> dict:
    """Phase 5's rule on `img`: the full runs agree on >= 0.99 of the
    alpha, and from the card's CNN mask the stages give the same bytes;
    returns the card run's launches of K1-K4 and the CG's update."""
    b, h, w = img.shape[:3]
    pipes = {dev: Pipeline(model="u2netp", k=16, device=dev)
             for dev in ("cuda", "cpu")}
    zero_counts()
    outs = {dev: [t.cpu() for t in pipe.run(img)]
            for dev, pipe in pipes.items()}
    launches = {k: v for k, v in read_counts().items() if k in SLICE_PATH}
    (g_rgba, g_alpha, g_pal), (c_rgba, c_alpha, c_pal) = outs["cuda"], outs["cpu"]
    agree = float((g_rgba[..., 3] == c_rgba[..., 3]).double().mean())
    refined = float((g_alpha == c_alpha).double().mean())
    print(f"[{tag}] Pipeline {b}x{h}x{w}: rgba alpha agreement "
          f"{agree:.6f}; refined u8 alpha exact {refined:.6f}; palettes "
          f"identical: {bool(torch.equal(g_pal, c_pal))}; card launches "
          f"{launches} ({label})")
    if agree < 0.99:
        fail(f"{tag}: card-vs-CPU alpha agreement {agree} < 0.99")

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
    print(f"[{tag}] matting + quantize from the card's CNN mask, "
          f"identical on card and CPU: {same}")
    if not all(same.values()):
        fail(f"{tag}: card and CPU stages differ from the same CNN mask: "
             f"{same}")
    return launches


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
    for k in ("k4", "k7"):
        print(f"[micros] quantize, {k.upper()} on the same frame "
              f"({'interleaved' if k == 'k4' else 'planes'}), ms back to back: "
              f"a whole-number palette {res[k + '_whole_ms']:.4f}, a "
              f"fractional one {res[k + '_fractional_ms']:.4f}, the two mixed "
              f"{res[k + '_mixed_ms']:.4f}, no palette entry "
              f"{res[k + '_k0_ms']:.4f}; the plain version's bytes: "
              f"{res[k + '_paths_exact']} ({label})")
    if not res["paths_exact"]:
        fail("micro_quantize: K4 or K7 gives other bytes than its plain "
             "version")
    rows = BENCH_HIST.run("cuda", H4K * W4K, BATCH)
    torch.cuda.synchronize()
    by_input = {}
    for row in rows:
        by_input.setdefault(row["input"], []).append(row)
        if not row["exact"]:
            fail(f"micro_hist_nibble: {row['kernel']} on {row['input']} "
                 "differs from np.bincount")
    for name, group in by_input.items():
        times = ", ".join(f"{r['kernel']} {r['ms']:.4f} / {r['ms_graph']:.4f}"
                          for r in group)
        print(f"[micros] histogram of {name} ({H4K * W4K} a row), all exact, "
              f"ms back to back / from a CUDA graph: {times} ({label})")
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

# photo-like RGBA with a transparent corner, a semi-transparent band and a
# dark patch (BASELINE config 1's frame in the bench)
quantizer_frame = BASELINE.quantizer_frame


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


# ---------------------------------------------------------------------------
# phase 10: GrabCut
# ---------------------------------------------------------------------------

def _fg_of(m):
    return (m == GC.FGD) | (m == GC.PR_FGD)


def _iou(a, b) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


_READS = ("__bool__", "item", "tolist", "cpu")


def host_reads(fn):
    """fn()'s result and the number of times it read a CUDA tensor on the
    host (bool, item, tolist, cpu): each is a device-to-host copy that
    waits for the card."""
    n = [0]
    own = {name: torch.Tensor.__dict__.get(name) for name in _READS}

    def counted(real):
        def read(self, *a, **k):
            if self.is_cuda:
                n[0] += 1
            return real(self, *a, **k)
        return read
    for name in _READS:
        setattr(torch.Tensor, name, counted(getattr(torch.Tensor, name)))
    try:
        out = fn()
    finally:
        for name, real in own.items():
            if real is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, real)
    return out, n[0]


def _grabcut_solve(fn, bgr, init):
    """One GrabCut call at config 4's settings: (mask, ms, the stamps,
    the host reads)."""
    (out, ms), reads = host_reads(lambda: _timed(
        lambda: fn(bgr, init, iterations=10, device="cuda").cpu().numpy()))
    return out, ms, dict(GC.LAST_SOLVE_INFO), reads


def run_grabcut(label: str) -> None:
    t_phase = time.perf_counter()
    h, w = GRABCUT_HW
    rect = SEEDS.config4_rect(h, w)
    x, y, rw, rh = rect
    outside = np.ones((h, w), bool)
    outside[y:y + rh, x:x + rw] = False
    init = np.where(outside, GC.BGD, GC.PR_FGD).astype(np.uint8)
    zero_counts()
    GC.clear_programs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for seed in (21, 22, 23):
        bgr, subject = SEEDS.portrait_scene(h, w, seed)
        (first, ms_first), reads = host_reads(lambda: _timed(
            lambda: GRABCUT.apply_grabcut(bgr, rect_xywh=rect,
                                          iterations=10)))
        if seed == 21:
            graphs = sum(p.graphs() for p in GC.programs())
            print(f"[grabcut] first compiled call {h}x{w}: {ms_first:.3f} ms "
                  f"with the warm-up (each loop stepped once) and the "
                  f"captures of {len(GC.programs())} programs, {graphs} "
                  f"graphs; device memory peak "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
                  f"reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB "
                  f"({label})")
            (out, ms), reads = host_reads(lambda: _timed(
                lambda: GRABCUT.apply_grabcut(bgr, rect_xywh=rect,
                                              iterations=10)))
            if not np.array_equal(out, first):
                fail(f"grabcut scene {seed}: a second call gives other bytes")
        else:
            out, ms = first, ms_first
        info = dict(GC.LAST_SOLVE_INFO)
        if out.dtype != np.uint8 or out.shape != (h, w):
            fail(f"grabcut: output is {out.dtype} {out.shape}")
        if not set(np.unique(out).tolist()) <= {0, 1, 2, 3}:
            fail("grabcut: mask values outside {0, 1, 2, 3}")
        if not (out[outside] == GC.BGD).all():
            fail("grabcut: a known background pixel changed")
        stamps = {k: v for k, v in info.items() if k.startswith("t_")}
        share = sum(stamps.values()) * 1e3 / ms
        listed = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in stamps.items())
        eager, ms_eager, e_info, e_reads = _grabcut_solve(
            GC._grabcut_core_eager, bgr, init)
        for key in ("cut_iters", "restart_accepted"):
            if info.get(key) != e_info.get(key):
                fail(f"grabcut scene {seed}: compiled {key} {info.get(key)}, "
                     f"eager {e_info.get(key)}")
        if not np.array_equal(out, eager):
            fail(f"grabcut scene {seed}: the compiled call's bytes differ "
                 f"from the eager call's on "
                 f"{(out != eager).mean():.6f} of the pixels")
        print(f"[grabcut] apply_grabcut {h}x{w} scene {seed}, 10 iterations, "
              f"split-merge polish: ok, compiled call identical to the "
              f"eager one (bytes, cut iterations, restart), foreground IoU "
              f"with the drawn subject {_iou(_fg_of(out), subject):.4f}; "
              f"compiled warm {ms:.3f} ms, eager {ms_eager:.3f} ms (host "
              f"reads of the call: compiled {reads}, eager {e_reads}); "
              f"stamps {listed} ms, {share * 100:.1f} % of the call; cut "
              f"iterations {info['cut_iters']}, restart "
              f"{info.get('restart_accepted', 'not run')} ({label})")
        if not 0.9 <= share <= 1.1:
            fail(f"grabcut: the stage stamps sum to {share:.3f} of the "
                 "call's wall, outside 10 %")
    launches = {k: v for k, v in read_counts().items() if v}
    print(f"[grabcut] kernel launches on the GrabCut path: {launches} "
          "(it holds no kernel)")

    # the workflow: strokes seed the cut on the whole canvas
    bgr, _ = SEEDS.portrait_scene(h, w, 21)
    strokes = np.zeros((h, w), np.uint8)
    strokes[int(0.3 * h):int(0.36 * h), int(0.45 * w):int(0.55 * w)] = 1
    strokes[int(0.7 * h):int(0.8 * h), int(0.4 * w):int(0.6 * w)] = 1
    strokes[int(0.02 * h):int(0.05 * h), int(0.05 * w):int(0.3 * w)] = 2
    rgba, ms = _timed(lambda: SEEDS.run_grabcut_workflow(bgr, strokes,
                                                         iterations=10))
    if rgba is None or rgba.dtype != np.uint8 or rgba.shape != (h, w, 4):
        fail("run_grabcut_workflow: no RGBA of the frame's size")
    if not (np.array_equal(rgba[..., :3], bgr[..., ::-1])
            and np.isin(rgba[..., 3], (0, 255)).all()):
        fail("run_grabcut_workflow: colours changed or alpha not in {0, 255}")
    print(f"[grabcut] run_grabcut_workflow {h}x{w} with strokes: ok, opaque "
          f"share {(rgba[..., 3] > 0).mean():.4f}; {ms:.3f} ms ({label})")

    # the Chambolle-Pock loop alone, at the full image (one lane) and at
    # the polish's coarse search (ten lanes): ms per iteration from a graph
    # and eagerly. The loop runs whole chunks, so it ran
    # ceil(max it / chunk) chunks
    g = torch.Generator(device="cuda").manual_seed(25)
    for lanes, (ch, cw) in ((1, (h, w)), (10, (256, 192))):
        unary = torch.randn((lanes, ch, cw), generator=g, device="cuda") * 4
        wts = GC._nlink_weights(
            torch.rand((3, ch, cw), generator=g, device="cuda") * 255)
        free = torch.zeros((lanes, ch, cw), dtype=torch.bool, device="cuda")
        args = (unary, wts, free, free)
        prog = Compiled(PROFILE_GC.cut_program(500, GC.CP_CHUNK),
                        [(t.shape, t.dtype) for t in args],
                        torch.device("cuda"))
        prog(*args)  # warm-up and capture
        (_, it, _), ms = _timed(lambda: prog(*args))
        GC.tv_mincut(unary, wts, free, free, max_iter=100)  # warm-up
        (_, it_e, _), ms_e = _timed(lambda: GC.tv_mincut(
            unary, wts, free, free, max_iter=500))
        if not torch.equal(it, it_e):
            fail(f"grabcut: the cut from a graph ran {it.tolist()} "
                 f"iterations, eagerly {it_e.tolist()}")
        ran = min(500, -(-int(it.max()) // GC.CP_CHUNK) * GC.CP_CHUNK)
        print(f"[grabcut] Chambolle-Pock loop {lanes}x{ch}x{cw}: "
              f"{ms / ran:.4f} ms per iteration from a graph, "
              f"{ms_e / ran:.4f} eagerly, over {ran} iterations, one host "
              f"read per {GC.CP_CHUNK} ({label})")
        del prog

    # the evaluator gives a lane the same bits at any lane count: ten lanes
    # as the polish ranks its candidates, two as the full-resolution
    # acceptance and the collapse restart score, against one-lane calls
    rng = np.random.default_rng(26)
    for lanes, (ch, cw) in ((10, (256, 192)), (2, (h, w))):
        bgr, subject = SEEDS.portrait_scene(ch, cw, 26)
        im = GC.prepare(torch.from_numpy(bgr).cuda())
        masks = torch.from_numpy(np.stack([
            subject ^ (rng.random((ch, cw)) < 0.01 * (i + 1))
            for i in range(lanes)]).astype(np.float32)).cuda()
        batched = GC.mask_energy(im, masks)
        single = torch.cat([GC.mask_energy(im, m[None]) for m in masks])
        if not torch.equal(batched, single):
            fail(f"grabcut: mask_energy over {lanes} lanes differs from "
                 f"one-lane calls by {(batched - single).abs().max()}")
        print(f"[grabcut] mask_energy {lanes}x{ch}x{cw}: each lane equals a "
              f"one-lane call bit for bit ({label})")

    # card against CPU
    sh, sw = GRABCUT_SMALL_HW
    bgr, _ = SEEDS.portrait_scene(sh, sw, 24)
    rect = SEEDS.config4_rect(sh, sw)
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = GRABCUT.apply_grabcut(bgr, rect_xywh=rect, iterations=10,
                                         device=dev)
        res[dev + "_ms"] = (time.perf_counter() - t0) * 1e3
        res[dev + "_info"] = dict(GC.LAST_SOLVE_INFO)
    iou = _iou(_fg_of(res["cuda"]), _fg_of(res["cpu"]))
    print(f"[grabcut] {sh}x{sw} card against CPU: foreground IoU {iou:.6f}, "
          f"equal bytes {(res['cuda'] == res['cpu']).mean():.6f}; cut "
          f"iterations card {res['cuda_info']['cut_iters']}, CPU "
          f"{res['cpu_info']['cut_iters']}; card {res['cuda_ms']:.1f} ms, CPU "
          f"{res['cpu_ms']:.1f} ms ({label})")
    if iou < 0.99:
        fail(f"grabcut: card-vs-CPU foreground IoU {iou} < 0.99")
    print(f"[grabcut] phase 10: {time.perf_counter() - t_phase:.1f} s "
          f"({label})")


# ---------------------------------------------------------------------------
# phase 11: ISNet, the ONNX writer and loader
# ---------------------------------------------------------------------------

def _check_rgba(rgba, rgb, what):
    h, w = rgb.shape[:2]
    if rgba.dtype != np.uint8 or rgba.shape != (h, w, 4):
        fail(f"{what}: output is {rgba.dtype} {rgba.shape}")
    if not np.array_equal(rgba[..., :3], rgb):
        fail(f"{what}: the colour channels are not the input's")
    if not np.isin(rgba[..., 3], (0, 255)).all():
        fail(f"{what}: sharp alpha is not in {{0, 255}}")


def run_isnet(label: str) -> int:
    h, w = COMPAT_HW
    rgb, _, _ = compat_case(h, w, seed=7)
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    REMBG.rembg_remove_bgr_to_rgba(bgr, model=ISNET)  # warm-up (cuDNN plans)
    zero_counts()
    rgba, ms = _timed(lambda: REMBG.rembg_remove_bgr_to_rgba(bgr, model=ISNET))
    k1 = read_counts()["histogram"]
    _check_rgba(rgba, rgb, "rembg isnet")
    if k1 <= 0:
        fail("rembg isnet: K1 was not launched (the Otsu sharp edges)")
    sess = REMBG._get_session(ISNET)
    n_par = sum(p.numel() for p in sess.module.parameters())
    print(f"[isnet] rembg_remove_bgr_to_rgba({ISNET}, {n_par / 1e6:.1f} M "
          f"parameters, seeded, input {sess.spec.size[0]}x{sess.spec.size[1]}) "
          f"{h}x{w}: ok, opaque share {(rgba[..., 3] > 0).mean():.3f}; "
          f"{ms:.3f} ms; K1 launches {k1} ({label})")
    mask_seeded = sess.predict_mask(rgb)

    # card against CPU
    sh, sw = COMPAT_SMALL_HW
    rgb_s, _, _ = compat_case(sh, sw, seed=9)
    bgr_s = np.ascontiguousarray(rgb_s[:, :, ::-1])
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = REMBG.rembg_remove_bgr_to_rgba(bgr_s, model=ISNET,
                                                  device=dev)
        res[dev + "_ms"] = (time.perf_counter() - t0) * 1e3
        _check_rgba(res[dev], rgb_s, f"rembg isnet on {dev}")
    agree = float((res["cuda"][..., 3] == res["cpu"][..., 3]).mean())
    print(f"[isnet] {sh}x{sw} card against CPU: sharp alpha agreement "
          f"{agree:.6f}; card {res['cuda_ms']:.1f} ms, CPU {res['cpu_ms']:.1f} "
          f"ms ({label})")
    if agree < 0.99:
        fail(f"rembg isnet: card-vs-CPU agreement {agree} < 0.99")

    # the seeded weights through the port's .onnx writer and loader
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, ISNET + ".onnx")
        t0 = time.perf_counter()
        ONNX_WRITER.export_torch_state(path, sess.module.state_dict())
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = REG.Session(ISNET, ckpt_path=path)
        t_load = time.perf_counter() - t0
        rep = loaded.load_report
        if not (loaded.weights_loaded and rep.complete
                and rep.mapped == rep.total):
            fail(f"isnet checkpoint: incomplete load: {rep.summary()}")
        if not np.array_equal(loaded.predict_mask(rgb), mask_seeded):
            fail("isnet checkpoint: the loaded session's mask differs from "
                 "the seeded session's")
        result = VERIFY.verify(path)
        if not (result["load"]["ok"] and len(result["activations"]) == 6
                and "mask" in result):
            fail(f"verify_checkpoint: {result.get('load')}")
        print(f"[isnet] checkpoint round trip: {os.path.getsize(path) / 1e6:.1f}"
              f" MB written in {t_write:.1f} s, loaded in {t_load:.1f} s "
              f"({rep.summary()}), the seeded session's mask bytes; "
              f"verify_checkpoint: {result['load']['summary']}, sharp "
              f"foreground share {result['mask']['sharp_fg_frac']}")
    return k1


# ---------------------------------------------------------------------------
# phase 12: region cleanup, tendrils and the harness at 4K
# ---------------------------------------------------------------------------

REGION_MIN = 100                # analyze and merge: min size, connectivity 8
REGION_CROP_HW = (1080, 1920)   # the smoothers and the harness
REGION_SMALL_HW = (270, 480)    # card against CPU
GLOBAL_ITERS = 100              # apply_boundary_smoothing_global's cap
GRAY = (128, 128, 128)          # the magenta cleanup's fallback colour
SMOOTHERS = ("morphological", "bilateral", "contour", "gaussian",
             "multiscale")


def _opaque_colours(rgba) -> set:
    opq = rgba[rgba[..., 3] > 0][:, :3].astype(np.int64)
    return set(np.unique((opq[:, 0] << 16) | (opq[:, 1] << 8) | opq[:, 2])
               .tolist())


def _region_calls(img, merged, crop, dev, info):
    """(name, input, call, palette check) for the steps of phase 12 after
    the analysis and the merge: `img` is the quantized frame, `merged` the frame after
    merge_small_regions, `crop` the smoothers' crop of it, all numpy; the
    trim's iteration count goes to info["trim_iterations"]."""
    RC, HARN, TRIM = REGION_CLEANUP, HARNESS, TENDRILS

    def trim():
        out, info["trim_iterations"], _ = TRIM.trim_tendrils(
            merged, 2, 30, device=dev)
        return out

    h, w = img.shape[:2]
    seed_xy = (w // 2, h // 2)
    fill = next(iter(sorted(_opaque_colours(img))))
    fill = ((fill >> 16) & 255, (fill >> 8) & 255, fill & 255)
    calls = [
        ("get_region_boundaries", img, lambda: RC.get_region_boundaries(
            img, 8, device=dev), "boundary"),
        ("flood_fill_region", img, lambda: RC.flood_fill_region(
            img, seed_xy, fill, device=dev), "palette"),
        ("trim_tendrils", merged, trim, "palette"),
    ]
    for m in SMOOTHERS:
        # gaussian blends a colour into its neighbours (reference :966):
        # its output is not held to the palette
        calls.append((f"smooth {m}", crop,
                      lambda m=m: RC.smooth_region_boundaries(
                          crop, m, 0.5, device=dev),
                      None if m == "gaussian" else "palette"))
    calls += [
        ("apply_boundary_smoothing_global", crop,
         lambda: HARN.apply_boundary_smoothing_global(
             crop, max_iterations=GLOBAL_ITERS, trim_tendrils_flag=True,
             progress_callback=lambda i, c, msg: info.__setitem__(
                 "global_iterations", i),
             device=dev), "palette+gray"),
        ("apply_custom_morphological_smoothing", crop,
         lambda: HARN.apply_custom_morphological_smoothing(
             crop, 5, "Ellipse", "Open then Close", device=dev), "palette"),
    ]
    return calls


def _check_region_output(name, out, ref, kind):
    if out.dtype != np.uint8 or out.shape != ref.shape:
        fail(f"{name}: output is {out.dtype} {out.shape}, expected uint8 "
             f"{ref.shape}")
    if kind == "boundary":
        if not (np.isin(out[..., 3], (0, 255)).all()
                and (out[..., :3] == 255).all() and out[..., 3].any()):
            fail(f"{name}: not white boundaries on transparency")
        return
    if kind is None:
        return
    allowed = _opaque_colours(ref)
    if kind == "palette+gray":
        allowed.add((GRAY[0] << 16) | (GRAY[1] << 8) | GRAY[2])
    extra = _opaque_colours(out) - allowed
    if extra:
        fail(f"{name}: {len(extra)} opaque colours outside the input's "
             f"palette, e.g. {hex(min(extra))}")


def run_region_cleanup(label: str, frame: np.ndarray) -> None:
    """Phase 12 on image 0 of phase 4's output (the k-16 palette, alpha in
    {0, 255}): every step twice on the card (same bytes), its warm wall,
    the merge passes and the tendril iterations; the device labels beside
    the native union-find; card against CPU on a small crop."""
    RC = REGION_CLEANUP
    dev = "cuda"
    h, w = frame.shape[:2]
    zero_counts()
    t_phase = time.perf_counter()

    # analyze_regions
    stats, ms1 = _timed(lambda: RC.analyze_regions(frame, REGION_MIN, 8, device=dev))
    stats2, ms = _timed(lambda: RC.analyze_regions(frame, REGION_MIN, 8, device=dev))
    keys = ("total_regions", "small_regions", "largest_region_size",
            "smallest_region_size", "size_distribution", "region_colors",
            "region_sizes")
    if any(stats[k] != stats2[k] for k in keys) or \
            [r["bbox"] for r in stats["all_regions"]] != \
            [r["bbox"] for r in stats2["all_regions"]]:
        fail("analyze_regions: a second call gives other statistics")
    print(f"[regions] analyze_regions {h}x{w} (min {REGION_MIN}, conn 8): "
          f"{stats['total_regions']} regions, {stats['small_regions']} under "
          f"{REGION_MIN}, largest {stats['largest_region_size']}; first "
          f"{ms1:.1f} ms, second {ms:.1f} ms, same statistics ({label})")

    # the device labels beside the native union-find on the same frame
    x = torch.as_tensor(frame, device=dev)
    cid, valid = PACK(x[..., :3]), x[..., 3] > 0
    CCOMP.component_stats(cid, valid, 8)
    CCOMP.HOST_READS = 0
    (labels, sizes, bbox), dev_ms = _timed(
        lambda: CCOMP.component_stats(cid, valid, 8))
    reads = CCOMP.HOST_READS
    cid_np, valid_np = cid.cpu().numpy(), valid.cpu().numpy()
    NATIVE.label_components_host(cid_np, valid_np, 8)
    t0 = time.perf_counter()
    host = NATIVE.label_components_host(cid_np, valid_np, 8)
    host_ms = (time.perf_counter() - t0) * 1e3
    for nm, a, b in zip(("labels", "sizes", "bbox"), (labels, sizes, bbox),
                        host):
        if not np.array_equal(a.cpu().numpy(), b):
            fail(f"component_stats: the card's {nm} differ from the native "
                 "union-find's")
    print(f"[regions] component_stats {h}x{w} conn 8 on the card "
          f"{dev_ms:.3f} ms ({reads} host reads of the fixpoint flag, "
          f"{CCOMP.SWEEPS_PER_READ} sweeps a read), native union-find "
          f"{host_ms:.3f} ms; labels, sizes and bboxes equal ({label})")

    # the merge: its passes, the regions under the size before and after,
    # and one pass's share beside the labels'
    def merge(passes):
        return RC.merge_small_regions(
            frame, REGION_MIN, auto_merge_threshold=0.7, connectivity=8,
            device=dev, progress_callback=lambda c, t, msg: passes.append(msg)
            if msg.startswith("Pass") and msg.endswith("Analyzing regions...")
            else None)

    passes, again = [], []
    merged, ms1 = _timed(lambda: merge(passes))
    merged2, ms = _timed(lambda: merge(again))
    if not np.array_equal(merged, merged2) or passes != again:
        fail("merge_small_regions: a second call gives other bytes")
    _check_region_output("merge_small_regions", merged, frame, "palette")
    wts = torch.tensor([0.4, 0.3, 0.2, 0.1], device=dev)
    thr = torch.tensor(0.7, device=dev)
    _, pass_ms = _timed(lambda: RC._merge_pass(x, labels, sizes, REGION_MIN,
                                               thr, wts, 8)[1].item())
    # The JAX package merges every small region of a pass at once, from the
    # pass-start image, and stops when a pass does not lower the count:
    # regions that swap colours, and islands in transparency, stay small.
    mx = torch.as_tensor(merged, device=dev)
    _, msizes, _ = CCOMP.component_stats(PACK(mx[..., :3]), mx[..., 3] > 0, 8)
    left = int(((msizes > 0) & (msizes < REGION_MIN)).sum())
    print(f"[regions] merge_small_regions {h}x{w}: ok, second call "
          f"identical; first {ms1:.1f} ms, warm {ms:.1f} ms; {len(passes)} "
          f"passes (a pass: labels {dev_ms:.1f} ms on the first frame, the "
          f"merge pass {pass_ms:.1f} ms); {stats['small_regions']} regions "
          f"under {REGION_MIN} before, {left} left ({label})")
    if not left < stats["small_regions"] or \
            len(passes) > DEFAULTS.merge_max_passes:
        fail(f"merge_small_regions: {left} regions under {REGION_MIN} left "
             f"of {stats['small_regions']} after {len(passes)} passes")

    # every step twice on the card; the tendrils, the smoothers and the
    # harness take the merged frame, as the app's flow does
    crop = np.ascontiguousarray(merged[:REGION_CROP_HW[0], :REGION_CROP_HW[1]])
    info, firsts = {}, {}
    for name, ref, call, kind in _region_calls(frame, merged, crop, dev,
                                               info):
        first, ms1 = _timed(call)
        firsts[name] = first
        again, ms = _timed(call)
        if not np.array_equal(first, again):
            fail(f"{name}: a second call gives other bytes")
        _check_region_output(name, first, ref, kind)
        extra = ""
        if name == "trim_tendrils":
            extra = f"; {info['trim_iterations']} iterations"
        if name == "apply_boundary_smoothing_global":
            # its guards, not its 30 s clock, must end it
            extra = (f"; {info['global_iterations']} iterations (cap "
                     f"{GLOBAL_ITERS}, tendrils on)")
            if max(ms1, ms) >= 0.5 * 30e3:
                fail(f"{name} took {max(ms1, ms):.0f} ms: its 30 s timeout "
                     "could end it, so a second call need not match")
        print(f"[regions] {name} {ref.shape[0]}x{ref.shape[1]}: ok, second "
              f"call identical; first {ms1:.1f} ms, warm {ms:.1f} ms"
              f"{extra} ({label})")

    # compare_smoothing_algorithms: each entry the direct call's bytes
    table = HARNESS.compare_smoothing_algorithms(crop, 0.5, device=dev)
    for m in SMOOTHERS:
        if not np.array_equal(table[m][0], firsts[f"smooth {m}"]):
            fail(f"compare_smoothing_algorithms: the {m} entry is not the "
                 "direct call's bytes")
    print(f"[regions] compare_smoothing_algorithms {REGION_CROP_HW[0]}x"
          f"{REGION_CROP_HW[1]}: every entry the direct call's bytes; "
          + ", ".join(f"{m} {table[m][1] * 1e3:.1f} ms" for m in SMOOTHERS)
          + f" ({label})")

    # card against CPU on a small crop of the frame and the merged frame
    t_small = time.perf_counter()
    sh, sw = REGION_SMALL_HW
    small = np.ascontiguousarray(frame[:sh, :sw])
    small_crop = np.ascontiguousarray(merged[:sh, :sw])
    res = {d: [(name, call()) for name, _, call, _ in
               _region_calls(small, small_crop, small_crop, d, {})]
           for d in (dev, "cpu")}
    a_dev = RC.analyze_regions(small, REGION_MIN, 8, device=dev)
    a_cpu = RC.analyze_regions(small, REGION_MIN, 8, device="cpu")
    if any(a_dev[k] != a_cpu[k] for k in keys):
        fail("analyze_regions: card and CPU statistics differ")
    for d in (dev, "cpu"):
        res[d].insert(0, ("merge_small_regions", RC.merge_small_regions(
            small, REGION_MIN, auto_merge_threshold=0.7, connectivity=8,
            device=d)))
    worst = {}
    for (name, g), (_, c) in zip(res[dev], res["cpu"]):
        d = np.abs(g.astype(np.int32) - c.astype(np.int32))
        if name in ("smooth gaussian", "smooth bilateral"):
            share = float((d.max(-1) == 0).mean())
            worst[name] = (int(d.max()), share)
            if share < 0.99 or (name == "smooth gaussian" and d.max() > 1):
                fail(f"{name}: card against CPU max {d.max()}, equal share "
                     f"{share}")
        elif d.max():
            fail(f"{name}: card and CPU bytes differ ({(d > 0).sum()} "
                 "values)")
    print(f"[regions] {sh}x{sw} card against CPU: analyze_regions and "
          f"{len(res[dev]) - len(worst)} steps equal bytes; "
          + ", ".join(f"{n} max {m}, equal share {s:.6f}"
                      for n, (m, s) in worst.items()) + f" ({label})")
    launched = {k: v for k, v in read_counts().items() if v}
    print(f"[regions] kernel launches in phase 12: {launched or 'none'} "
          "(this slice has no CUDA kernel of its own)")
    t_end = time.perf_counter()
    print(f"[regions] phase 12: {t_end - t_phase:.1f} s, of which card "
          f"against CPU {t_end - t_small:.1f} s ({label})")


# ---------------------------------------------------------------------------
# phase 13: the CLI on the card
# ---------------------------------------------------------------------------

CLI_HW = (768, 1024)          # runs A and C
CLI_PORTRAIT_HW = (384, 512)  # run B
CLI_SMALL_HW = (96, 128)      # run B's flags, card against CPU
CLI_PALETTE = "ff0000,00ff00,0000ff"
CLI_CARD_VS_CPU_MIN = 0.99


def _cli(argv):
    """cli.main in this process: (exit code, stdout, wall ms, K1 launches)."""
    zero_counts()
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = CLI.main([str(a) for a in argv])
    torch.cuda.synchronize()
    return rc, out.getvalue(), (time.perf_counter() - t0) * 1e3, \
        read_counts()["histogram"]


def _cli_twice(name, src, dst, flags):
    """Two runs of one command line: exit 0, the same output bytes (and
    stdout) both times; returns the decoded output, stdout, walls, K1."""
    rc1, out1, ms1, k1 = _cli([src, dst, *flags])
    first = open(dst, "rb").read()
    rc2, out2, ms2, _ = _cli([src, dst, *flags])
    if (rc1, rc2) != (0, 0):
        fail(f"cli run {name}: exit codes {rc1}, {rc2}")
    if open(dst, "rb").read() != first or out1 != out2:
        fail(f"cli run {name}: a second run gives other bytes")
    return CLI._load_rgba(dst), out1, (ms1, ms2), k1


def _check_cli_rgba(name, rgba, hw, rgb=None, binary=False, colours=None,
                    max_colours=None):
    if rgba.dtype != np.uint8 or rgba.shape != (*hw, 4):
        fail(f"cli run {name}: output is {rgba.dtype} {rgba.shape}")
    if rgb is not None and not np.array_equal(rgba[..., :3], rgb):
        fail(f"cli run {name}: the colour channels are not the input's")
    if binary and not np.isin(rgba[..., 3], (0, 255)).all():
        fail(f"cli run {name}: alpha is not in {{0, 255}} after sharp rembg")
    opaque = _opaque_colours(rgba)
    if colours is not None and not opaque <= colours:
        fail(f"cli run {name}: opaque colours outside the palette")
    # kmeans leaves the pixels out of its fit black (its reference's
    # black-filter ladder), so black comes on top of the k centres
    if max_colours is not None and len(opaque - {0}) > max_colours:
        fail(f"cli run {name}: {len(opaque - {0})} opaque colours besides "
             f"black > {max_colours}")


def run_cli(label: str) -> None:
    """Phase 13: `cli.main` in this process on seeded PNGs written by the
    port's codec: run A (u2netp rembg, kmeans, cleanup, smoothing, trim,
    stats), run B (GrabCut rect, portrait refine, custom palette, majority)
    and run C (rembg with the UI's default ISNet, no simplification), each
    twice; A once more through `python -m`; B's flags without the refine
    on the card and on the CPU."""
    t_phase = time.perf_counter()
    h, w = CLI_HW
    ph, pw = CLI_PORTRAIT_HW
    rgb_a = photo_batch(1, h, w, seed=13)[0]
    rgb_b = np.ascontiguousarray(SEEDS.portrait_scene(ph, pw, 24)[0][..., ::-1])
    rect_b = ",".join(map(str, SEEDS.config4_rect(ph, pw)))
    rgb_s = np.ascontiguousarray(
        SEEDS.portrait_scene(*CLI_SMALL_HW, 25)[0][..., ::-1])
    rect_s = ",".join(map(str, SEEDS.config4_rect(*CLI_SMALL_HW)))
    palette = {int(c, 16) for c in CLI_PALETTE.split(",")}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, rgb in (("a", rgb_a), ("b", rgb_b), ("s", rgb_s)):
            paths[name] = os.path.join(tmp, f"{name}.png")
            with open(paths[name], "wb") as f:
                f.write(CLI._png_encode(rgb))
        flags_a = ["--rembg", "--model", "u2netp", "--colors", "8",
                   "--algorithm", "kmeans", "--cleanup", "--smooth",
                   "morphological", "--trim-tendrils", "2", "--stats", "-q"]
        out_a = os.path.join(tmp, "a_out.png")
        rgba, stdout, ms, k1 = _cli_twice("A", paths["a"], out_a, flags_a)
        _check_cli_rgba("A", rgba, CLI_HW, binary=True, max_colours=8)
        stats = json.loads(stdout[stdout.index("{"):])
        if stats["color"]["image_size"] != [h, w] or \
                stats["regions"]["total_regions"] <= 0:
            fail(f"cli run A: --stats reads {stats}")
        if k1 <= 0:
            fail("cli run A: K1 was not launched (the Otsu sharp edges)")
        print(f"[cli] A {h}x{w} rembg u2netp + kmeans 8 + cleanup + "
              f"morphological + trim 2 + stats: ok, {len(_opaque_colours(rgba))}"
              f" colours, {stats['regions']['total_regions']} regions, "
              f"opaque share {(rgba[..., 3] > 0).mean():.3f}; wall "
              f"{ms[0]:.1f} ms first, {ms[1]:.1f} ms second; K1 launches "
              f"{k1} ({label})")
        t0 = time.perf_counter()
        svg = SVG.export_svg(rgba)
        print(f"[cli] export_svg of run A's output: {svg.count('<path')} "
              f"paths, {len(svg) / 1e6:.2f} MB, "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        # one layer a colour, none for a colour whose every region traces
        # to fewer than three points
        if not 0 < svg.count("<path") <= len(_opaque_colours(rgba)):
            fail("export_svg: the layers do not match the opaque colours")

        sub_out = os.path.join(tmp, "a_sub.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "image_segmenter_tpu_torch.cli",
             paths["a"], sub_out, *flags_a], capture_output=True, text=True,
            timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0:
            fail(f"python -m image_segmenter_tpu_torch.cli: exit "
                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        if open(sub_out, "rb").read() != open(out_a, "rb").read() \
                or proc.stdout != stdout:
            fail("python -m image_segmenter_tpu_torch.cli: other bytes than "
                 "the in-process run")
        print(f"[cli] python -m image_segmenter_tpu_torch.cli (run A): exit "
              f"0, the in-process bytes and stats; "
              f"{time.perf_counter() - t0:.1f} s with its start-up")

        flags_b = ["--grabcut-rect", rect_b, "--refine-portrait",
                   "--palette", CLI_PALETTE, "--smooth", "majority", "-q"]
        rgba, _, ms, _ = _cli_twice("B", paths["b"],
                                    os.path.join(tmp, "b_out.png"), flags_b)
        _check_cli_rgba("B", rgba, CLI_PORTRAIT_HW, colours=palette)
        print(f"[cli] B {ph}x{pw} grabcut {rect_b} + refine + palette "
              f"{CLI_PALETTE} + majority: ok, opaque share "
              f"{(rgba[..., 3] > 0).mean():.3f}; wall {ms[0]:.1f} ms first, "
              f"{ms[1]:.1f} ms second ({label})")

        rgba, _, ms, k1 = _cli_twice("C", paths["a"],
                                     os.path.join(tmp, "c_out.png"),
                                     ["--rembg", "--no-simplify", "-q"])
        _check_cli_rgba("C", rgba, CLI_HW, rgb=rgb_a, binary=True)
        if k1 <= 0:
            fail("cli run C: K1 was not launched (the Otsu sharp edges)")
        print(f"[cli] C {h}x{w} rembg {DEFAULTS.rembg_model} (default) "
              f"--no-simplify: ok, opaque share {(rgba[..., 3] > 0).mean():.3f}"
              f"; wall {ms[0]:.1f} ms first, {ms[1]:.1f} ms second; K1 "
              f"launches {k1} ({label})")

        # card against CPU: GrabCut gives the CPU's mask (phase 10); the
        # palette map and the majority vote are integer work
        flags_s = ["--grabcut-rect", rect_s, "--palette", CLI_PALETTE,
                   "--smooth", "majority", "-q"]
        res = {}
        for dev in ("cuda", "cpu"):
            dst = os.path.join(tmp, f"s_{dev}.png")
            rc, _, ms, _ = _cli([paths["s"], dst, *flags_s, "--device", dev])
            if rc != 0:
                fail(f"cli card against CPU: exit {rc} on {dev}")
            res[dev] = (CLI._load_rgba(dst), ms)
        same = float((res["cuda"][0] == res["cpu"][0]).all(-1).mean())
        print(f"[cli] run B's flags without the refine at "
              f"{CLI_SMALL_HW[0]}x{CLI_SMALL_HW[1]}, card against CPU: "
              f"{same:.6f} of the pixels equal in all four bytes (threshold "
              f"{CLI_CARD_VS_CPU_MIN}: GrabCut's card-against-CPU bound of "
              f"phase 10); card {res['cuda'][1]:.1f} ms, CPU "
              f"{res['cpu'][1]:.1f} ms")
        if same < CLI_CARD_VS_CPU_MIN:
            fail(f"cli card against CPU: {same} < {CLI_CARD_VS_CPU_MIN}")
    print(f"[cli] phase 13: {time.perf_counter() - t_phase:.1f} s ({label})")


# ---------------------------------------------------------------------------
# phase 14: U^2-Netp training on the card
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_HW = 8, (320, 320)
TRAIN_WARMUP, TRAIN_TIMED = 2, 20
TRAIN_SAVE_AT = 10            # the checkpoint holds the state after 10 steps
TRAIN_PROFILED = 3
TRAIN_SMALL = (2, 64, 64)     # card against CPU
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def train_batch(b: int, h: int, w: int, seed: int):
    """Normalised photo-like images (B, 3, H, W) and blob masks (B, H, W)
    in {0, 1}, from a seed."""
    rng = np.random.default_rng(seed)
    imgs = (photo_batch(b, h, w, seed).astype(np.float32) / 255.0 - _MEAN) / _STD
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    masks = np.zeros((b, h, w), np.float32)
    for i in range(b):
        for cy, cx, ry, rx in rng.uniform((0.2, 0.2, 0.1, 0.1),
                                          (0.8, 0.8, 0.3, 0.3), (3, 4)):
            masks[i][((yy / h - cy) / ry) ** 2 + ((xx / w - cx) / rx) ** 2
                     < 1] = 1.0
    return (torch.from_numpy(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))),
            torch.from_numpy(masks))


def _train_card_vs_cpu(label: str) -> None:
    """One step's loss, gradients and new statistics from the same seeded
    weights on the card and the CPU, on the batch and with the bounds of
    tests/test_torch_cuda.py::test_train_step_card_matches_cpu (standard
    normal images). Not on the photo-like batch: its smooth 64 x 64 images
    leave the innermost BatchNorms tiny variances under large means, where
    float32 E[y^2] - E[y]^2 cancels, and the gradients of two float32
    implementations (the JAX package's and the port's on the CPU too)
    differ by tens of percent, so no bound on a gradient tells a fault
    from rounding there."""
    b, h, w = TRAIN_SMALL
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.standard_normal((b, 3, h, w))
                            .astype(np.float32))
    masks = torch.from_numpy((rng.random((b, h, w)) > 0.6).astype(np.float32))
    res = {}
    for dev in ("cuda", "cpu"):
        module = U2NET(small=True).to(dev)
        _, state = TRAIN.create_train_state(module, seed=0, input_hw=(h, w))
        loss, grads, stats = TRAIN.loss_and_grads(module, state, imgs.to(dev),
                                                  masks.to(dev))
        res[dev] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                    {k: v.cpu() for k, v in stats.items()})
    (lg, gg, sg), (lc, gc, sc) = res["cuda"], res["cpu"]
    rel, bias = [], 0.0
    for k, g in gg.items():
        if k.endswith("conv_s1.bias"):  # ahead of a BatchNorm: 0 exactly
            bias = max(bias, float(g.abs().max()), float(gc[k].abs().max()))
            continue
        rel.append(float((g - gc[k]).norm() / gc[k].norm().clamp_min(1e-30)))
    stats_err = max(float((v - sc[k]).abs().max()) for k, v in sg.items())
    loss_rel = abs(lg - lc) / abs(lc)
    print(f"[train] card against CPU, one step at {b}x{h}x{w}: loss "
          f"{lg:.6f} / {lc:.6f} (relative {loss_rel:.2e}, bound 1e-4); "
          f"gradient relative L2 median {statistics.median(rel):.2e}, max "
          f"{max(rel):.2e} (bounds 0.1, 0.25); conv biases ahead of a "
          f"BatchNorm |g| <= {bias:.1e} (bound 1e-4); statistics max "
          f"|diff| {stats_err:.2e} (bound 1e-3) ({label})")
    if loss_rel > 1e-4 or statistics.median(rel) > 0.1 or max(rel) > 0.25 \
            or bias > 1e-4 or stats_err > 1e-3:
        fail("training step: card and CPU differ beyond the stated bounds")


def run_train(label: str) -> None:
    """Phase 14: `pipeline/train` on U^2-Netp at its published 320 x 320
    input, batch 8, float32: warm-up, timed steps, peak memory, the loss
    falling, the device's busy share from a profile, the checkpoint round
    trip at step 10, and one step on the card against the CPU."""
    t_phase = time.perf_counter()
    b, (h, w) = TRAIN_BATCH, TRAIN_HW
    module = U2NET(small=True).cuda()
    tx, state = TRAIN.create_train_state(module, seed=0, input_hw=(h, w))
    step = TRAIN.make_train_step(module, tx)
    imgs, masks = train_batch(b, h, w, seed=14)
    imgs, masks = imgs.cuda(), masks.cuda()
    zero_counts()
    losses, walls, saved = [], [], None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pt")
        for i in range(TRAIN_WARMUP + TRAIN_TIMED):
            if i == TRAIN_WARMUP:
                torch.cuda.reset_peak_memory_stats()
            if state.step == TRAIN_SAVE_AT:
                TRAIN.save_checkpoint(path, state)
                saved = state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, imgs, masks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated()
        launched = {k: v for k, v in read_counts().items() if v}
        if launched:
            fail(f"training step launched port kernels: {launched}")
        ms = statistics.median(walls[TRAIN_WARMUP:]) * 1e3
        last = TRAIN_TIMED
        if not all(np.isfinite(losses)) or not losses[last] < losses[0]:
            fail(f"training loss is not finite and falling: {losses}")
        print(f"[train] U2NETP {b}x3x{h}x{w} float32, Adam 1e-3: "
              f"{ms:.3f} ms/step (median of {TRAIN_TIMED} after "
              f"{TRAIN_WARMUP} warm-up; {min(walls[TRAIN_WARMUP:]) * 1e3:.3f}"
              f"-{max(walls[TRAIN_WARMUP:]) * 1e3:.3f}), "
              f"{b / ms * 1e3:.1f} images/s; peak {peak / 2**30:.3f} GiB; loss "
              f"step 0 {losses[0]:.6f}, step {last} {losses[last]:.6f} "
              f"({label})")

        trace = PROF.capture_device_trace(
            lambda: [step(state, imgs, masks) for _ in range(TRAIN_PROFILED)],
            os.path.join(tmp, "trace"))
        busy_us = sum(t for _, t, _ in trace)
        events = sum(c for _, _, c in trace)
        if not trace:
            fail("capture_device_trace saw no device operation")
        print(f"[train] profile of {TRAIN_PROFILED} steps: device busy "
              f"{busy_us / 1e3 / TRAIN_PROFILED:.3f} ms a step of "
              f"{ms:.3f} unprofiled: busy share "
              f"{busy_us / 1e3 / (TRAIN_PROFILED * ms):.3f}; "
              f"{events / TRAIN_PROFILED:.0f} device operations a step; top 5: "
              + "; ".join(f"{n[:60]} {t / 1e3 / TRAIN_PROFILED:.3f} ms x"
                          f"{c // TRAIN_PROFILED}" for n, t, c in trace[:5]))

        _, fresh = TRAIN.create_train_state(U2NET(small=True).cuda(), seed=1)
        restored = TRAIN.restore_checkpoint(path, fresh)
        for part in ("params", "batch_stats"):
            for k, v in getattr(saved, part).items():
                if not torch.equal(getattr(restored, part)[k], v):
                    fail(f"checkpoint: {part} {k} is not bit-equal")
        for m in ("mu", "nu"):
            for k, v in saved.opt_state[m].items():
                if not torch.equal(restored.opt_state[m][k], v):
                    fail(f"checkpoint: Adam {m} {k} is not bit-equal")
        if (restored.step, restored.opt_state["count"]) != (TRAIN_SAVE_AT,) * 2:
            fail("checkpoint: the step or Adam's count changed")
        _, loss = step(restored, imgs, masks)
        ref = losses[TRAIN_SAVE_AT]
        rel = abs(float(loss) - ref) / abs(ref)
        print(f"[train] checkpoint at step {TRAIN_SAVE_AT} "
              f"({os.path.getsize(path) / 1e6:.1f} MB): every tensor "
              f"bit-equal after the round trip; the next step's loss "
              f"{float(loss):.6f} against {ref:.6f} uninterrupted (relative "
              f"{rel:.2e}, bound 1e-4)")
        if rel > 1e-4:
            fail(f"checkpoint: the restored step's loss differs by {rel}")
    _train_card_vs_cpu(label)
    print(f"[train] phase 14: {time.perf_counter() - t_phase:.1f} s ({label})")


# ---------------------------------------------------------------------------
# phase 15: the device mesh, every slot on this card
# ---------------------------------------------------------------------------

MESH_SLOTS = 4
MESH_BLOCKS = ((100, 5), (200, 8), (300, 12), (150, 291))  # (first row, rows)
TRAIN_DP = (8, 320, 3)        # batch (4 a rank), input size, steps


def _slots(n: int) -> list:
    return [torch.device("cuda", torch.cuda.current_device())] * n


def _contract(rgba, ref, imgs, what):
    try:
        return GRAFT.band_contract(rgba, ref, imgs, what)
    except AssertionError as e:
        fail(f"{what}: the dry run's boundary-band contract: {e}")


def _differences(a, b) -> dict:
    """Per output: how many bytes differ and in which images and rows."""
    out = {}
    for name, x, y in zip(a._fields, a, b):
        d = (x != y)
        if bool(d.any()):
            per = d.reshape(d.shape[0], d.shape[1], -1).any(-1)
            out[name] = {"bytes": int(d.sum()),
                         "images": per.any(1).nonzero().flatten().tolist(),
                         "rows": [int(per.any(0).nonzero().min()),
                                  int(per.any(0).nonzero().max())]}
    return out


def _cnn_split(pipe_1, x, parts: int):
    """Phase 4's CNN on the batch cut as `parts` slots cut it."""
    return torch.cat([pipe_1.stages.cnn(pipe_1.session.module, x[a:b])
                      for a, b in PM.split_bounds(x.shape[0], parts)])


def _against_split_cnn(what: str, out, x, imgs, pipe_1, ref, parts: int):
    """Hold a sharded run to the unsharded one. cuDNN rounds the CNN's
    bfloat16 convolutions by batch size, so the CNN on a part of the batch
    gives another u8 mask than on all of it (within 2 steps: the rounding
    of bf16 between libraries and devices). Everything after the CNN is
    held to bytes: the run must be the unsharded stages from the masks of
    the CNN cut as the run cuts it. The dry run's boundary-band contract
    against the unsharded output (phase 4's) is reported."""
    m_all = pipe_1.stages.cnn(pipe_1.session.module, x)
    m_cut = _cnn_split(pipe_1, x, parts)
    dm = (m_all.int() - m_cut.int()).abs()
    if int(dm.max()) > 2:
        fail(f"{what}: the CNN on parts of the batch is {int(dm.max())} "
             "steps from the whole batch's (bf16 rounding reaches 2)")
    diff = _differences(out, pipe_1.run_from_mask(x, m_cut))
    if diff:
        fail(f"{what}: not the unsharded stages' bytes from its CNN masks: "
             f"{diff}")
    try:
        agree, qerr = GRAFT.band_contract(out[0].cpu().numpy(),
                                          ref[0].cpu().numpy(), imgs, what)
        vs_all = (f"within it (alpha agreement {agree:.6f}, quantization "
                  f"error {[(round(a, 3), round(c, 3)) for a, c in qerr]})")
    except AssertionError as e:
        vs_all = f"outside it: {e}"
    return (f"the CNN at batch {x.shape[0] // parts} against {x.shape[0]}: "
            f"{float((dm > 0).double().mean()):.6f} of the mask's bytes "
            f"differ, by at most {int(dm.max())}; from those masks the "
            f"unsharded stages' bytes; the dry run's contract against the "
            f"unsharded output: {vs_all}")


def _mesh_pipeline(label: str, x, imgs, pipe_1, ref) -> None:
    mesh = PM.make_mesh((2, 2), devices=_slots(MESH_SLOTS))
    pipe = Pipeline(model="u2netp", k=16, sharding=PM.batch_sharding(mesh))
    pipe.run(x)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    out = pipe.run(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if k in MAIN_PATH}
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the sharded Pipeline")
    check_output(out, 16, BATCH, H4K, W4K)
    again = pipe.run(x)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail("sharded Pipeline: a second run is not bit-identical")
    held = _against_split_cnn("sharded Pipeline (2, 2)", out, x, imgs,
                              pipe_1, ref, 2)
    walls = []
    for _ in range(5):
        _, ms = _timed(lambda: pipe.run(x))
        walls.append(ms)
    _, ms_1 = _timed(lambda: pipe_1.run(x))
    print(f"[mesh] Pipeline(u2netp, k=16, sharding=batch_sharding((2, 2) of "
          f"{MESH_SLOTS} slots on one card)) {BATCH}x{H4K}x{W4K}: outputs ok, "
          f"second run bit-identical, launches {launches}; {held}; warm "
          f"{statistics.median(walls):.3f} ms/batch (median of 5: "
          f"{', '.join(f'{t:.3f}' for t in walls)}), unsharded {ms_1:.3f} "
          f"({label})")

    mask = pipe_1.stages.cnn(pipe_1.session.module, x)
    a = pipe.run_from_mask(x, mask)
    b = pipe_1.run_from_mask(x, mask)
    diff = _differences(a, b)
    print(f"[mesh] matting (rows over 2 slots) and quantize stages sharded "
          f"from phase 4's CNN mask against unsharded: "
          f"{'the same bytes' if not diff else diff} ({label})")
    _contract(a.rgba.cpu().numpy(), b.rgba.cpu().numpy(), imgs,
              "sharded stages from one mask")


def _mesh_refine(label: str) -> None:
    h, w = COMPAT_HW
    rgb, soft_alpha, user = compat_case(h, w, seed=7)
    smesh = PM.make_mesh((1, MESH_SLOTS), devices=_slots(MESH_SLOTS))
    REFINE.refine_alpha_portrait_full_res(rgb, soft_alpha, user, mesh=smesh)
    one, ms_1 = _timed(lambda: REFINE.refine_alpha_portrait_full_res(
        rgb, soft_alpha, user))
    sh, ms_sh = _timed(lambda: REFINE.refine_alpha_portrait_full_res(
        rgb, soft_alpha, user, mesh=smesh))
    _check_alpha(sh, (h, w), "sharded full-resolution refine")
    d = np.abs(sh.astype(np.int32) - one.astype(np.int32))
    print(f"[mesh] refine_alpha_portrait_full_res {h}x{w} rows over (1, "
          f"{MESH_SLOTS}): {'the unsplit bytes' if not d.any() else f'{int((d > 0).sum())} pixels differ, max {int(d.max())}'}; "
          f"{ms_sh:.3f} ms split, {ms_1:.3f} ms unsplit ({label})")
    if (d > 0).mean() >= 0.01 or d.max() > 2:
        fail("sharded full-resolution refine: beyond the dry run's bound "
             "(1 % of pixels, 2 steps)")


def _mesh_blocks(label: str) -> None:
    """K2 and K3 on the row blocks the sharded solve gives them: each
    block extended by 2 rows on its interior edges; the kernels against
    their plain versions' bits, and the block's own rows against the
    whole image's."""
    g = torch.Generator(device="cuda").manual_seed(15)
    img = torch.rand((BATCH, 3, MH, MW), generator=g, device="cuda")
    p = torch.randn((BATCH, MH, MW), generator=g, device="cuda")
    whole = KP.precompute_planes(img, 1e-7)
    whole_mv = KMV.matvec_planes(whole, img, p)
    cuts = PM.split_bounds(MH, MESH_SLOTS)
    blocks = [("first", *cuts[0]), ("interior", *cuts[1]),
              ("last", *cuts[-1])] + [(f"{n} rows", r0, r0 + n)
                                      for r0, n in MESH_BLOCKS]
    errs = []
    for name, r0, r1 in blocks:
        e0, e1 = max(0, r0 - 2), min(MH, r1 + 2)
        im = img[:, :, e0:e1].contiguous()
        pp = p[:, e0:e1].contiguous()
        planes = KP.precompute_planes(im, 1e-7)
        ref = KP.precompute_planes_plain(im, 1e-7)
        err = _precompute_err(planes, ref)
        mv = KMV.matvec_planes(planes, im, pp)
        checks = {
            "K2 bits": torch.equal(planes, ref),
            "K3 bits": torch.equal(mv, KMV.matvec_planes_plain(planes, im,
                                                               pp)),
            "K2 rows": torch.equal(planes[:, :, r0 - e0:r1 - e0],
                                   whole[:, :, r0:r1]),
            "K3 rows": torch.equal(mv[:, r0 - e0:r1 - e0], whole_mv[:, r0:r1]),
        }
        if not (err < 1e-4 and all(checks.values())):
            fail(f"K2 / K3 on the {name} block [{r0}, {r1}): error {err}, "
                 f"{checks}")
        errs.append(err)
    print(f"[mesh] K2 and K3 on row blocks of {BATCH}x{MH}x{MW} "
          f"({', '.join(f'{n} [{a}, {b})' for n, a, b in blocks)}; 2 ghost "
          f"rows on each interior edge): the plain versions' bits, the whole "
          f"image's rows, K2 max error {max(errs):.1e} (bound 1e-4) ({label})")


def _mesh_staged(label: str, imgs, pipe_1, ref) -> None:
    batches = [imgs, np.ascontiguousarray(imgs[:, :, ::-1]),
               np.ascontiguousarray(imgs[:, ::-1])]
    meshes = split_stage_meshes(_slots(MESH_SLOTS), fractions=(2, 1, 1))
    spipe = StagedPipeline(model="u2netp", k=16, meshes=meshes,
                           device="cuda")
    spipe.run(batches[0])  # warm-up
    outs, ms = _timed(lambda: [[t.clone() for t in o]
                               for o in spipe.run_stream(batches)])
    refs = [ref] + [pipe_1.run(b) for b in batches[1:]]
    _, ms_fused = _timed(lambda: [pipe_1.run(b) for b in batches])
    held = []
    for i, (b, o, r) in enumerate(zip(batches, outs, refs)):
        x = torch.from_numpy(b).to("cuda")
        held.append(f"batch {i}: " + _against_split_cnn(
            f"staged batch {i}", type(r)(*o), x, b, pipe_1, r,
            meshes[0].size))
    print(f"[mesh] StagedPipeline {[m.size for m in meshes]} slots, 3 "
          f"batches of {BATCH}x{H4K}x{W4K} (as is, flipped left-right, "
          f"flipped up-down) streamed, in order; {'; '.join(held)}; "
          f"{ms / 3:.3f} ms a batch, fused {ms_fused / 3:.3f} ({label})")


def run_mesh(label: str) -> None:
    """Phase 15: the sharded paths on slots of this one card."""
    t_phase = time.perf_counter()
    imgs = photo_batch(BATCH, H4K, W4K, seed=0)
    x = torch.from_numpy(imgs).to("cuda")
    pipe_1 = Pipeline(model="u2netp", k=16, device="cuda")
    ref = pipe_1.run(x)
    sha = {name: BENCH_K12._sha(t) for name, t in zip(ref._fields, ref)}
    if sha != MAIN_PATH_SHA256:
        fail(f"phase 15's unsharded reference changed: {sha}")
    _mesh_pipeline(label, x, imgs, pipe_1, ref)
    _mesh_refine(label)
    _mesh_blocks(label)
    _mesh_staged(label, imgs, pipe_1, ref)

    t0 = time.perf_counter()
    try:
        line = GRAFT.dryrun_multichip(MESH_SLOTS, device="cuda")
    except (AssertionError, RuntimeError) as e:
        fail(f"dryrun_multichip({MESH_SLOTS}): {e}")
    print(f"[mesh] {line}; {time.perf_counter() - t0:.1f} s ({label})")

    b, hw, steps = TRAIN_DP
    t0 = time.perf_counter()
    try:
        reports = GRAFT.check_train("cuda", b, hw, steps=steps)
    except (AssertionError, RuntimeError) as e:
        fail(f"sharded training step over two ranks: {e}")
    for space, tr in reports.items():
        rows = "whole rows" if space == 1 else f"its rows over {space} slots"
        print(f"[mesh] shard_train_step, U2NETP {b}x3x{hw}x{hw} over 2 "
              f"{tr['backend']} ranks on {', '.join(tr['slots'])} ({b // 2} "
              f"a rank, {rows}), {steps} steps: ms a step "
              f"{', '.join(f'{t:.3f}' for t in tr['ms'])} (one rank on the "
              f"whole batch {', '.join(f'{t:.3f}' for t in tr['ms_1'])}); "
              f"loss {', '.join(f'{v:.6f}' for v in tr['loss'])} against "
              f"{', '.join(f'{v:.6f}' for v in tr['loss_1'])} (relative "
              f"gaps {', '.join(f'{v:.2e}' for v in tr['loss_gaps'])}; step "
              f"1 bound 1e-4); after step 1 fuse conv max |diff| "
              f"{tr['held_maxdiff']:.1e}, {tr['params_over']} of "
              f"{tr['params_total']} parameters over 1e-4 ({label})")
    print(f"[mesh] both layouts: {time.perf_counter() - t0:.1f} s with the "
          f"ranks' start-up ({label})")
    print(f"[mesh] phase 15: {time.perf_counter() - t_phase:.1f} s ({label})")


# ---------------------------------------------------------------------------
# phase 16: the training step's rows split over the space axis
# ---------------------------------------------------------------------------

SPLIT_MESHES = ((1, 2), (1, 4), (2, 2))  # slots of this card
SPLIT_STEPS = 3
SPLIT_FULL = (2, 320, 320)    # the full U^2-Net: batch, input size; (1, 2)


def _peaks(devices) -> str:
    return ", ".join(f"{d} {torch.cuda.max_memory_allocated(d) / 2**30:.3f} "
                     "GiB" for d in devices)


def _reset_peaks(devices) -> None:
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)


def _split_run(what: str, step, sharded, state0, imgs, masks, steps: int,
               slots) -> dict:
    """`steps` steps of `sharded` from `state0`, each held against the
    one-slot step from the same state: the loss within 1e-4 relative;
    after step 1 `GRAFT.HELD_PARAMS` within 1e-4 and the statistics within
    1e-3; every parameter moved over the run. The last step also reads
    the peak memory of each slot's device; then one more sharded step is
    profiled for its device operations and busy time. Returns the walls
    and readings; fails on a broken bound."""
    devices = sorted(set(slots), key=str)
    state, walls, gaps, first = state0, [], [], None
    for i in range(steps):
        if i == steps - 1:
            _reset_peaks(devices)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, loss = sharded(state, imgs, masks)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == steps - 1:
            peaks = _peaks(devices)
        ref, loss_1 = step(state, imgs, masks)
        gaps.append(abs(float(loss) - float(loss_1)) / abs(float(loss_1)))
        if not np.isfinite(float(loss)) or gaps[-1] > 1e-4:
            fail(f"{what}: step {i + 1}'s loss {float(loss)} against "
                 f"{float(loss_1)} one slot (relative {gaps[-1]:.2e}, bound "
                 "1e-4)")
        if i == 0:
            held = max(float((new.params[k] - ref.params[k]).abs().max())
                       for k in GRAFT.HELD_PARAMS)
            stats = max(float((v - ref.batch_stats[k]).abs().max())
                        for k, v in new.batch_stats.items())
            if held > 1e-4 or stats > 1e-3:
                fail(f"{what}: after step 1 {GRAFT.HELD_PARAMS} differ by "
                     f"{held:.2e} (bound 1e-4), the statistics by "
                     f"{stats:.2e} (bound 1e-3)")
            first = (held, stats)
        state = new
    moved = min(float((v - state0.params[k]).abs().max())
                for k, v in state.params.items())
    if not moved > 0:
        fail(f"{what}: a parameter did not move in {steps} steps")
    with tempfile.TemporaryDirectory() as tmp:
        trace = PROF.capture_device_trace(lambda: sharded(state, imgs, masks),
                                          tmp)
    if not trace:
        fail(f"{what}: capture_device_trace saw no device operation")
    warm = walls[1:] or walls
    return {"ms": statistics.median(warm), "walls": walls, "gaps": gaps,
            "held": first[0], "stats": first[1], "peaks": peaks,
            "busy_ms": sum(t for _, t, _ in trace) / 1e3,
            "ops": sum(c for _, _, c in trace)}


def _split_line(r: dict) -> str:
    return (f"{r['ms']:.3f} ms a step (median of the warm steps; "
            f"{', '.join(f'{t:.3f}' for t in r['walls'])}), loss gaps "
            f"{', '.join(f'{g:.2e}' for g in r['gaps'])} (bound 1e-4), after "
            f"step 1 fuse conv max |diff| {r['held']:.1e} (bound 1e-4), "
            f"statistics {r['stats']:.1e} (bound 1e-3); one profiled step: "
            f"{r['ops']} device operations, busy {r['busy_ms']:.3f} ms, busy "
            f"share {r['busy_ms'] / r['ms']:.3f}; peak {r['peaks']}")


def run_row_split(label: str) -> None:
    """Phase 16: `shard_train_step` with image rows split over the space
    slots (pipeline/train, parallel/spatial) on U^2-Netp at 320 x 320,
    batch 8, over (1, 2), (1, 4) and (2, 2) slots of this card, and the
    full U^2-Net over (1, 2), each against the one-slot step; on a host
    with two or four cards, also (1, 2) and (1, 4) a card a slot."""
    t_phase = time.perf_counter()
    b, (h, w) = TRAIN_BATCH, TRAIN_HW
    dev = _slots(1)[0]
    zero_counts()
    module = U2NET(small=True).to(dev)
    tx, state0 = TRAIN.create_train_state(module, seed=0, input_hw=(h, w))
    step = TRAIN.make_train_step(module, tx)
    imgs, masks = (t.to(dev) for t in train_batch(b, h, w, seed=16))
    step(state0, imgs, masks)  # warm-up
    _reset_peaks([dev])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state0, imgs, masks)
    torch.cuda.synchronize()
    ms_1 = (time.perf_counter() - t0) * 1e3
    peak_1 = _peaks([dev])
    print(f"[split] U2NETP {b}x3x{h}x{w} float32, one slot: {ms_1:.3f} ms a "
          f"warm step, peak {peak_1} ({label})")
    for shape in SPLIT_MESHES:
        slots = _slots(shape[0] * shape[1])
        sharded = TRAIN.shard_train_step(step, PM.make_mesh(shape,
                                                            devices=slots))
        r = _split_run(f"row split {shape}", step, sharded, state0, imgs,
                       masks, SPLIT_STEPS, slots)
        print(f"[split] shard_train_step U2NETP {b}x3x{h}x{w} over {shape} "
              f"slots of one card, {SPLIT_STEPS} steps each held to the "
              f"one-slot step from the same state: {_split_line(r)} "
              f"({label})")

    for n in (2, 4):
        if torch.cuda.device_count() < n:
            print(f"[split] (1, {n}) a card a slot: not measured (this host "
                  f"has {torch.cuda.device_count()} card(s)) ({label})")
            continue
        cards = [torch.device("cuda", i) for i in range(n)]
        sharded = TRAIN.shard_train_step(step, PM.make_mesh((1, n),
                                                            devices=cards))
        r = _split_run(f"row split over {n} cards", step, sharded, state0,
                       imgs, masks, SPLIT_STEPS, cards)
        print(f"[split] shard_train_step U2NETP {b}x3x{h}x{w} over (1, {n}), "
              f"a card a slot: {_split_line(r)}; one card alone: peak "
              f"{peak_1} ({label})")

    fb, fh, fw = SPLIT_FULL
    full = U2NET(small=False).to(dev)
    ftx, fstate0 = TRAIN.create_train_state(full, seed=0, input_hw=(fh, fw))
    fstep = TRAIN.make_train_step(full, ftx)
    fimgs, fmasks = (t.to(dev) for t in train_batch(fb, fh, fw, seed=17))
    r = _split_run("full U2NET row split (1, 2)", fstep,
                   TRAIN.shard_train_step(fstep, PM.make_mesh(
                       (1, 2), devices=_slots(2))),
                   fstate0, fimgs, fmasks, 1, _slots(2))
    n_params = sum(p.numel() for p in full.parameters())
    print(f"[split] shard_train_step full U2NET ({n_params / 1e6:.1f} M "
          f"parameters) {fb}x3x{fh}x{fw} "
          f"over (1, 2) slots of one card, one step: {_split_line(r)} "
          f"({label})")
    launched = {k: v for k, v in read_counts().items() if v}
    if launched:
        fail(f"the row-split training step launched port kernels: {launched}")
    print(f"[split] phase 16: {time.perf_counter() - t_phase:.1f} s ({label})")


# ---------------------------------------------------------------------------
# phase 17: the measuring programs
# ---------------------------------------------------------------------------

PROGRAM_REPS = 2              # the bench's calls a round, the profile's a row


def _bench_line() -> tuple:
    """The bench as a user runs it, at its default 4K batch: (stdout,
    stderr)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_REPS=str(PROGRAM_REPS), BENCH_SECONDARY="none")
    proc = subprocess.run(
        [sys.executable, "-m", "image_segmenter_tpu_torch.bench.bench"],
        env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"the bench exited with {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    return proc.stdout, proc.stderr


def check_bench_record(rec: dict, content: str, metric: str, label: str,
                       slice_launches: dict) -> None:
    """A bench record holds every field, names its run and its card, has
    positive rates and phase 4's K1, K2 and K4 launches (its batch is not
    phase 4's, so the CG's K3 launches may differ)."""
    missing = [k for k in BENCH_HEAD.FIELDS if k not in rec]
    if missing or rec["metric"] != metric or rec["content"] != content:
        fail(f"a bench record lacks {missing} or names another run than "
             f"{metric} ({content}): {rec}")
    if not (rec["value"] > 0 and rec["device_resident_mp_s"] > 0):
        fail(f"the bench's MP/s are not positive: {rec}")
    if rec["card"] != label:
        fail(f"the bench's card {rec['card']!r} is not {label!r}")
    fixed = ("histogram", "precompute", "quantize")
    if (any(rec["launches"][k] != slice_launches[k] for k in fixed)
            or rec["launches"]["matvec"] < 1):
        fail(f"the bench's launches {rec['launches']} ({content}) are not "
             f"phase 4's {slice_launches}")


def run_programs(label: str, slice_launches: dict) -> None:
    """Phase 17: the bench, the stage profile and BASELINE configs 1, 2
    and 5, each held to its contract."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out, err = _bench_line()
    for line in err.splitlines():
        if line.startswith("[bench]"):
            print(f"[programs] {line}")
    lines = out.splitlines()
    if len(lines) != 1:
        fail(f"the bench printed {len(lines)} stdout lines, not one: {out!r}")
    rec = json.loads(lines[0])
    metric = f"pipeline_u2netp_matting_kmeans16_{H4K}x{W4K}_b{BATCH}"
    synthetic = [json.loads(line.split(" ", 2)[2]) for line in err.splitlines()
                 if line.startswith("[bench] synthetic {")]
    if len(synthetic) != 1:
        fail(f"the bench's stderr holds {len(synthetic)} synthetic records")
    for r, content, name in ((rec, "photo", metric + "_photo"),
                             (synthetic[0], "synthetic", metric)):
        check_bench_record(r, content, name, label, slice_launches)
    print(f"[programs] bench, synthetic batch (stderr): "
          f"{synthetic[0]['value']:.3f} MP/s streaming, device-resident "
          f"{synthetic[0]['device_resident_mp_s']:.3f} MP/s, launches "
          f"{synthetic[0]['launches']} ({label})")
    print(f"[programs] bench, photo mosaic (stdout): {rec['value']:.3f} MP/s "
          f"streaming "
          f"({rec['ms_per_batch']:.3f} ms a batch, rounds "
          f"{rec['spread']['min']:.3f}-{rec['spread']['max']:.3f}), "
          f"device-resident {rec['device_resident_mp_s']:.3f} MP/s "
          f"({rec['device_resident_ms_per_batch']:.3f} ms, "
          f"{rec['device_resident_spread']['min']:.3f}-"
          f"{rec['device_resident_spread']['max']:.3f}), host-to-device "
          f"{rec['h2d_gbs']} GB/s ({label})")
    print(f"[programs] bench line: {lines[0]}")

    with contextlib.redirect_stderr(sys.stdout):
        res = PROFILE.profile("cuda", BATCH, H4K, W4K, reps=PROGRAM_REPS,
                              imgs=photo_batch(BATCH, H4K, W4K, seed=0))
        PROFILE.print_table(res)
    if len(res["rows"]) != 14 or any(r["device_ops"] is None
                                     for r in res["rows"]):
        fail(f"profile_stages: rows without a device view: {res['rows']}")
    if res["launches"] != slice_launches:
        fail(f"profile_stages launched {res['launches']} in one run, phase 4 "
             f"{slice_launches}")
    for key in ("idle_share", "idle_share_unprofiled", "compiled_idle_share",
                "compiled_idle_share_unprofiled"):
        if not 0.0 <= res[key] <= 1.0:
            fail(f"profile_stages: {key} {res[key]} outside [0, 1]")
    print(f"[programs] profile_stages {BATCH}x{H4K}x{W4K}: sum of stages "
          f"{res['sum_stages_ms']:.3f} ms against the full run "
          f"{res['full_ms']:.3f}; busy share {res['busy_share']:.4f}, idle "
          f"share {res['idle_share']:.4f} (against the unprofiled run "
          f"{res['idle_share_unprofiled']:.4f}); compiled run "
          f"{res['compiled_ms']:.3f} ms, idle share "
          f"{res['compiled_idle_share']:.4f} (against the unprofiled run "
          f"{res['compiled_idle_share_unprofiled']:.4f}); launches as "
          f"phase 4's ({label})")

    for config in (BASELINE.config_1, BASELINE.config_2, BASELINE.config_4,
                   BASELINE.config_5):
        with contextlib.redirect_stderr(sys.stdout):
            r = config(reps=1, device="cuda")
        if not r["mp_s"] > 0:
            fail(f"BASELINE config {r['config']}: {r}")
        print(f"[programs] BASELINE config {r['config']} ({r['desc']}; "
              f"{r['content']}): {r['mp_s']:.3f} MP/s, one rep ({label})")
        if r["config"] == 4:
            gc_info = r["grabcut"]["last_solve_info"]
            print(f"[programs] BASELINE config 4: compiled GrabCut "
                  f"{r['grabcut']['s']:.3f} s for {len(r['crops'])} crops "
                  f"({r['grabcut']['s'] / len(r['crops']):.3f} s a call; "
                  f"the last: cut iterations {gc_info['cut_iters']}, "
                  f"t_init {gc_info['t_init']:.3f} s, t_em "
                  f"{gc_info['t_em']:.3f} s, t_polish "
                  f"{gc_info.get('t_polish', 0.0):.3f} s), matting "
                  f"{r['matting']['s']:.3f} s ({label})")
    print(f"[programs] phase 17: {time.perf_counter() - t_phase:.1f} s "
          f"({label})")


# ---------------------------------------------------------------------------
# phase 18: the photo corpus and the programs that read it
# ---------------------------------------------------------------------------

PHOTO_IOU = ("china", "flower", "sky_01-up", "style_01-floor_blue_d")
PHOTO_SIZE = 256              # corpus_iou's default size
PHOTO_TILE = (1, 1080, 1920)  # the headline mosaic's first image, cropped
IOU_FLOOR = CORPUS_IOU.IOU_FLOOR  # BASELINE.json's acceptance
MICRO_REPS = 1                # one warm and one timed call: the phase's
                              # budget; the micros' own default is 5
MICROS = (MICRO_ENVELOPE, MICRO_U2NETP, MICRO_KMEANS, MICRO_FIT_SAMPLE,
          MICRO_HSV_FIT, MICRO_DBSCAN)


def _check_photo_record(rec: dict) -> None:
    """corpus_iou's acceptance and its card-against-CPU agreement (phase
    7's rule: at most one step, >= 0.999 of the alpha equal; equal alpha
    bytes quantize to equal palettes)."""
    name = rec["image"]
    if rec["mask_iou"] < IOU_FLOOR:
        fail(f"corpus_iou {name}: mask IoU {rec['mask_iou']} against the "
             f"float64 oracle < {IOU_FLOOR}")
    if (rec["card_cpu_alpha_max_step"] > 1
            or rec["card_cpu_alpha_equal"] < 0.999
            or rec["card_cpu_mask_iou"] < IOU_FLOOR):
        fail(f"corpus_iou {name}: the card's alpha differs from the CPU's: "
             f"{rec}")
    if rec["card_cpu_alpha_equal"] == 1.0 and not rec["card_cpu_palette_equal"]:
        fail(f"corpus_iou {name}: equal alpha, other palettes on the card "
             f"and the CPU")


def run_photos(label: str) -> None:
    """Phase 18: the corpus's PNGs against their manifest, corpus_iou on
    four photos, the pipeline on a photo tile against the CPU, and each
    attribution micro once at its default shape."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    entries = CORPUS.manifest()
    photos = [CORPUS.read_photo(e) for e in entries]  # raises on a mismatch
    if len(photos) != 14:
        fail(f"the corpus holds {len(photos)} photos, not 14")
    print(f"[photos] corpus: {len(photos)} PNGs decoded here, shapes and "
          f"sha256s as MANIFEST.json's, {sum(p.nbytes for p in photos)} RGB "
          f"bytes, {time.perf_counter() - t0:.3f} s")

    corpus = dict(CORPUS.load_corpus(size=PHOTO_SIZE))
    for name in PHOTO_IOU:
        with contextlib.redirect_stdout(sys.stderr):
            rec = CORPUS_IOU.run_image(name, corpus[name], device="cuda")
        print(f"[photos] corpus_iou {json.dumps(rec)}")
        _check_photo_record(rec)
    print(f"[photos] corpus_iou on {len(PHOTO_IOU)} photos at "
          f"{PHOTO_SIZE}x{PHOTO_SIZE}: mask IoU >= {IOU_FLOOR} against the "
          f"float64 oracle, the card as the CPU ({label})")

    img = BENCH_HEAD.photo_batch(*PHOTO_TILE)
    launches = pipeline_card_vs_cpu(img, "photos", label)
    for name, n in launches.items():
        if n <= 0:
            fail(f"the photo tile's run launched no {name}")

    for mod in MICROS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--reps", str(MICRO_REPS)], device="cuda")
        lines = buf.getvalue().splitlines()
        if len(lines) != 1:
            fail(f"{mod.__name__} printed {len(lines)} lines, not one")
        rec = json.loads(lines[0])
        if rec["card"] != label or not rec["device"].startswith("cuda"):
            fail(f"{mod.__name__} ran on {rec['device']} ({rec['card']})")
        print(f"[photos] {mod.__name__.rsplit('.', 1)[1]} "
              f"({time.perf_counter() - t0:.1f} s): {lines[0]}")
    print(f"[photos] phase 18: {time.perf_counter() - t_phase:.1f} s "
          f"({label})")


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
        "cg_update": check_cg_update(label, dev),
        "sam_attention": check_sam_attention(label, dev),
        "resample": check_resample(label, dev),
        "deform_conv": check_deform_conv(label, dev),
        "swin_attention": check_swin_attention(label, dev),
    }
    launches, frame = run_slice(label)
    launches["sam_attention"] = run_sam_slice(label)["sam_attention"]
    bir = run_birefnet_slice(label)
    launches["deform_conv"] = bir["deform_conv"]
    launches["swin_attention"] = bir["swin_attention"]
    card_vs_cpu(label)
    launches.update(run_variants(label))
    run_compat(label)
    launches.update(run_micros(label))
    run_quantizers(label)
    run_grabcut(label)
    run_isnet(label)
    run_region_cleanup(label, frame)
    run_cli(label)
    run_train(label)
    run_mesh(label)
    run_row_split(label)
    run_programs(label, {k: launches[k] for k in MAIN_PATH})
    run_photos(label)

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
