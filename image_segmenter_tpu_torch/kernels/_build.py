"""Build and bind the hand-written CUDA kernels.

All of `csrc/*.cu` is compiled by nvcc for sm_90a into ONE shared library
with a plain C interface, loaded with ctypes. The library is named by a
hash of the sources and flags, so an edit to any source rebuilds it at
first use; an unchanged tree loads the cached library from `_build/`.
Nothing is compiled at import time: `library()` builds on first call.

Every C entry returns `cudaGetLastError()` after its launch; `check`
raises on a non-zero code. There is no fallback to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --fmad=false: no contraction of a*b+c into FMAs, so each kernel rounds
# where its plain PyTorch version rounds (K2, K3 match it bit for bit).
# --threads 0: nvcc compiles the sources side by side, one thread a core
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "--threads", "0", "-shared",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# C entry -> argtypes. Pointers and the stream are void*; every entry
# returns an int cudaError_t.
SIGNATURES = {
    # (x u8 (B, n), n, B, blocks a row, scratch int32 (>= B, 257) all zero,
    #  out f32 (B, 256), stream)
    "iseg_hist256": [_P, _I64, _I32, _I32, _P, _P, _P],
    # (img f32 (B, 3, H, W), B, H, W, eps, rows a run,
    #  out f32 (B, 12, H, W), stream)
    "iseg_precompute": [_P, _I32, _I32, _I32, _F32, _I32, _P, _P],
    # (planes f32 (B, 12, H, W), img f32 (B, 3, H, W), p f32 (B, H, W),
    #  B, H, W, rows a run, out f32 (B, H, W), stream)
    "iseg_matvec": [_P, _P, _P, _I32, _I32, _I32, _I32, _P, _P],
    # (rgb u8 (B, H*W, 3), fit u8 (B, H*W), centers f32 (B, k_max, 3),
    #  thr f32 (B,), B, H*W, k_max, k_real, out u8 (B, H*W, 3), stream)
    "iseg_quantize": [_P, _P, _P, _P, _I32, _I64, _I32, _I32, _P, _P],
    # (stack f32 (B, 13, Hp, Wp), p f32 (B, H, W), B, H, W, Hp, Wp,
    #  out f32 (B, H, W), stream)
    "iseg_matvec_stack": [_P, _P, _I32, _I32, _I32, _I32, _I32, _P, _P],
    # (p_pad f32 (B, Hp, Wp), static f32 (B, 10, Hp, Wp), B, Hp, Wp, Ho,
    #  rows a run, out f32 (B, Ho, Wp), stream)
    "iseg_matvec_recompute": [_P, _P, _I32, _I32, _I32, _I32, _I32, _P, _P],
    # (planes u8 (3, B, H*W), alpha u8 (B, H*W), centers f32 (B, k_max, 3),
    #  thr f32 (B,), B, H*W, k_max, k_real, blocks an image,
    #  out u8 (3, B, H*W), stream)
    "iseg_quantize_flat": [_P, _P, _P, _P, _I32, _I64, _I32, _I32, _I32, _P,
                           _P],
    # (x u8 (B, n), n, B, step, blocks a row, scratch int32 (>= B, 257) all
    #  zero, out f32 (B, 256), stream)
    "iseg_hist_variant": [_P, _I64, _I32, _I32, _I32, _P, _P, _P],
    # (lq f32 (B, H, W) in, y out, q, known, p, active bool (B,), B, H*W,
    #  blocks an image, lam, partials f64 (B, blocks, 2), stream)
    "iseg_cg_dot": [_P, _P, _P, _P, _P, _I32, _I64, _I32, _F32, _P, _P],
    # (y, b, m_inv, x in/out, r in/out, p, partials of p.y and p.p, rz f32
    #  (B,), pending bool, active bool, B, H*W, blocks an image, partials
    #  of r.z and r.r out, stream)
    "iseg_cg_advance": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I64,
                        _I32, _P, _P],
    # (m_inv, r, x, p in/out, q out or null, the two partials, rz, pending,
    #  it int32, active in, the same four out, bnorm f32 (B,), rtol,
    #  max_iter, B, H*W, blocks an image, flag bool out or null, stream)
    "iseg_cg_direction": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _F32, _I32, _I32, _I64, _I32, _P,
                          _P],
    # (q, its strides over window or frame, head, token; k, its; v, its;
    #  rel_h bf16 (B' heads, h, w, h), its four strides; rel_w (B' heads,
    #  h, w, w), its; B', heads, h, w, d, scale, out bf16 (B', h w,
    #  heads d), stream)
    "iseg_sam_attention": [_P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _P,
                           _I64, _I64, _I64, _P, _I64, _I64, _I64, _I64, _P,
                           _I64, _I64, _I64, _I64, _I32, _I32, _I32, _I32,
                           _I32, _F32, _P, _P],
    # (x u8 (B, H, W, C), B, H, W, C, ys int32 (dh,), wy f64 (dh, ky), dh,
    #  ky, xs int32 (dw,), wx f64 (dw, kx), dw, kx, tile rows, tile
    #  columns, span, out u8 (B, dh, C, dw), stream)
    "iseg_resample_u8": [_P, _I32, _I32, _I32, _I32, _P, _P, _I32, _I32, _P,
                         _P, _I32, _I32, _I32, _I32, _I32, _P, _P],
    # (x bf16 (B, H, W, 64), offset f32 (B, H, W, 2 k^2), mask f32 (B, H,
    #  W, k^2), weight bf16 (256, k, k, 64), bias f32 (256,) or null, relu,
    #  B, H, W, k, out bf16 (B, H, W) pixels ldo apart, ldo, stream)
    "iseg_deform_conv": [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                         _P, _I64, _P],
    # (qkv bf16 (B, H, W, 3C), its strides over frame, row, token; bias
    #  bf16 (3C,); table f32 (529, heads), its two strides; B, H, W, C,
    #  heads, shift, scale, out bf16 (B, H, W, C), stream)
    "iseg_swin_attention": [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _I32,
                            _I32, _I32, _I32, _I32, _I32, _F32, _P, _P],
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libiseg_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of the same sources exists."""
    out = _lib_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cus = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cus]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {rc}")
