"""Sweep: K7's pixel group and grid, K6's strip, prefetch depth and runs.

Each variant is the kernel's own source (kernels/csrc/quantize_flat.cu,
kernels/csrc/matvec_recompute.cu) with one compile-time constant changed,
built by nvcc with the library's flags into a shared library of its own
under kernels/_build/sweep/ (all variants side by side), bound with
ctypes, held to the kernel's plain version and timed: `LAUNCHES` launches
back to back between two CUDA events, median of `REPS`. The grid, which
the wrappers choose, is swept through the C entries' own arguments: K7's
blocks for each image as so many blocks an SM, K6's run length as the
runs that so many blocks an SM allow.

- K7: pixels a palette loop serves (`kGroup`: 4, 8, 16) x blocks an SM
  (8, 16, 32), on a whole-number palette and a fractional one, at
  4 x 2160 x 3840, k 16 (bench/micro_quantize.py's inputs).
- K6: strip width (`SW`: 124, 128) x stages in flight (`kPrefetch`: 2, 3)
  x blocks an SM (2 to 6), at 4 x 576 x 1024 (bench/micro_matvec.py's
  operands).

    python -m image_segmenter_tpu_torch.bench.sweep_k6_k7
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import torch

from image_segmenter_tpu_torch.bench import micro_matvec as MM
from image_segmenter_tpu_torch.bench import micro_quantize as MQ
from image_segmenter_tpu_torch.bench.micro_matvec import LAUNCHES, REPS
from image_segmenter_tpu_torch.kernels import _build
from image_segmenter_tpu_torch.kernels import matting as K6
from image_segmenter_tpu_torch.kernels import quantize_flat as K7

SWEEP_DIR = _build.BUILD_DIR / "sweep"
K7_GROUPS = (4, 8, 16)
K7_BLOCKS_PER_SM = (8, 16, 32)
K6_STRIPS = (124, 128)
K6_PREFETCH = (2, 3)
K6_BLOCKS_PER_SM = (2, 3, 4, 5, 6)


def variant_source(name: str, **consts: int) -> str:
    """csrc/<name> with each `constexpr int KEY = <n>;` set to consts[KEY];
    raises if the source has no such constant."""
    src = (_build.CSRC / name).read_text()
    for key, value in consts.items():
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {value};", src)
        if n != 1:
            raise ValueError(f"{name} has {n} definitions of {key}")
    return src


def variants() -> dict:
    """tag -> (source file, constants) of every variant swept."""
    out = {f"k7_group{g}": ("quantize_flat.cu", {"kGroup": g})
           for g in K7_GROUPS}
    out.update({f"k6_sw{sw}_prefetch{pf}": ("matvec_recompute.cu",
                                            {"SW": sw, "kPrefetch": pf})
                for sw in K6_STRIPS for pf in K6_PREFETCH})
    return out


def build_all() -> dict:
    """tag -> (ctypes library, ptxas's register lines), all built at once."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (name, consts) in variants().items():
        cu = SWEEP_DIR / f"{tag}.cu"
        cu.write_text(variant_source(name, **consts))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-Xptxas", "-v", "-o", str(SWEEP_DIR / f"{tag}.so"), str(cu)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lib = ctypes.CDLL(str(SWEEP_DIR / f"{tag}.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", log)
        libs[tag] = (lib, "/".join(regs))
    return libs


def _time(call) -> float:
    return MQ.median_ms(call, True, REPS, LAUNCHES)


def sweep_k7(libs, sms: int, b: int = 4, h: int = 2160,
             w: int = 3840) -> list:
    rgb, alpha, centers, thr = MQ.setup("cuda", b, h, w)
    planes = K7.split_planes(rgb)
    alpha_flat = alpha.reshape(b, h * w)
    pals = MQ.palettes(centers)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for tag in (t for t in libs if t.startswith("k7")):
        lib, regs = libs[tag]
        for per_sm in K7_BLOCKS_PER_SM:
            blocks = max(1, min(-(-(h * w) // (K7.PIXELS * K7.THREADS)),
                                -(-(sms * per_sm) // b)))
            for kind in ("whole", "fractional"):
                pal, k_real = pals[kind]
                ref = K7.quantize_planes_plain(planes, alpha_flat, pal,
                                               k_real, thr)
                out = torch.empty_like(planes)

                def call():
                    rc = lib.iseg_quantize_flat(
                        planes.data_ptr(), alpha_flat.data_ptr(),
                        pal.data_ptr(), thr.data_ptr(), b, h * w,
                        pal.shape[1], k_real, blocks, out.data_ptr(), stream)
                    _build.check(rc, tag)
                call()
                rows.append({"variant": tag, "registers": regs,
                             "blocks_per_sm": per_sm, "palette": kind,
                             "equal": bool(torch.equal(out, ref)),
                             "ms_back_to_back": _time(call)})
    return rows


def sweep_k6(libs, sms: int, b: int = 4, h: int = 576,
             w: int = 1024) -> list:
    _, ps, _, _, static = MM.setup("cuda", b, h, w)
    p_pad = K6.pad_p(ps)
    ref = K6.matvec_planes_plain(p_pad, static)
    _, hp, wp = p_pad.shape
    ho = ref.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for tag in (t for t in libs if t.startswith("k6")):
        lib, regs = libs[tag]
        strips = -(-wp // int(re.search(r"sw(\d+)", tag).group(1)))
        for per_sm in K6_BLOCKS_PER_SM:
            runs = max(1, per_sm * sms // (strips * b))
            run_rows = max(K6.MIN_RUN_ROWS, -(-ho // runs))
            out = torch.empty_like(ref)

            def call():
                rc = lib.iseg_matvec_recompute(
                    p_pad.data_ptr(), static.data_ptr(), b, hp, wp, ho,
                    run_rows, out.data_ptr(), stream)
                _build.check(rc, tag)
            call()
            rows.append({"variant": tag, "registers": regs,
                         "blocks_per_sm": per_sm, "run_rows": run_rows,
                         "blocks": strips * b * -(-ho // run_rows),
                         "equal": bool(torch.equal(out, ref)),
                         "ms_back_to_back": _time(call)})
    return rows


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs an NVIDIA GPU")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[sweep] {out.stdout.strip()}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_all()
    rows = sweep_k7(libs, sms) + sweep_k6(libs, sms)
    for row in rows:
        print("[sweep] " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                      else f"{k} {v}" for k, v in row.items()),
              flush=True)
    if not all(row["equal"] for row in rows):
        raise SystemExit("a variant differs from its plain version")


if __name__ == "__main__":
    main(sys.argv)
